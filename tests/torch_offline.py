"""Keeps the port's checkpoint downloader off the network in a test module.

A node given no ``params`` and no checkpoint file goes to
``utils.download``, which tries its mirrors over the network. A module
imports the fixture (``from torch_offline import no_downloads``); in that
module's tests a download of any URL but a ``file://`` one raises ``OSError``
at once, so a missing checkpoint raises ``FileNotFoundError`` and nothing
leaves the machine. ``file://`` mirrors (``tests/test_torch_utils.py``) still
download.
"""

import urllib.parse
import urllib.request

import pytest


@pytest.fixture(autouse=True)
def no_downloads(monkeypatch):
    real = urllib.request.urlretrieve

    def local_only(url, *args, **kwargs):
        if urllib.parse.urlparse(url).scheme != "file":
            raise OSError(f"{url}: the tests download nothing")
        return real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlretrieve", local_only)
