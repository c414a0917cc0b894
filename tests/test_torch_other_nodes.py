"""The port's non-VFI nodes and registry against the JAX package's, on the
CPU.

* ``Gradually_More_Denoise_KSampler``: the three tests of
  ``tests/test_other_nodes.py`` on torch tensors (the denoise schedule and
  the packing, by ``torch.cat``; over 1.0 refused; no bound sampler refused).
* ``MakeInterpolationStateList`` and ``FloatToInt`` give what the JAX nodes
  give.
* ``INPUT_TYPES`` and the protocol attributes of the CAIN, Sepconv and three
  non-VFI nodes equal the JAX nodes' (the VFI nodes' tooltips, which speak of
  the TPU there and of the card here, removed).
* ``NODE_CLASS_MAPPINGS`` and ``NODE_DISPLAY_NAME_MAPPINGS`` equal the JAX
  package's, all 18 nodes, in the same order (the test keeps the name it had
  while ``"MOMO VFI"`` was left out); ``register`` adds a node as JAX's does.
"""

import numpy as np
import pytest
import torch

from comfyui_frame_interpolation_tpu import nodes as jnodes
from comfyui_frame_interpolation_tpu_torch import nodes as pnodes
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

KS_NAME = "KSampler Gradually Adding More Denoise (efficient)"
KS = pnodes.NODE_CLASS_MAPPINGS[KS_NAME]


@pytest.fixture(autouse=True)
def _reset_sampler():
    old = KS._sampler_fn
    yield
    KS._sampler_fn = old


def test_denoise_schedule_and_packing():
    calls = []

    def fake_sampler(model, seed, steps, cfg, sampler_name, scheduler, positive, negative, latent, denoise):
        calls.append(denoise)
        return {"samples": latent["samples"] + denoise}

    KS.set_sampler(fake_sampler)
    node = KS()
    lat = {"samples": torch.zeros((2, 4, 8, 8))}
    out = node.sample(
        model="m", positive="p", negative="n", latent_image=lat,
        start_denoise=0.1, denoise_increment=0.2, denoise_increment_steps=3,
    )
    # per latent sample: denoise 0.1, 0.3, 0.5; two samples -> 6 outputs
    assert np.allclose(calls, [0.1, 0.3, 0.5, 0.1, 0.3, 0.5])
    samples = out[3]["samples"]
    assert isinstance(samples, torch.Tensor) and tuple(samples.shape) == (6, 4, 8, 8)
    assert np.allclose(samples[:, 0, 0, 0].numpy(), [0.1, 0.3, 0.5, 0.1, 0.3, 0.5])
    assert out[0] == "m" and out[1] == "p" and out[2] == "n" and out[4] is None
    assert lat["samples"].shape == (2, 4, 8, 8)  # the input latent dict is left as it was


def test_denoise_over_one_rejected():
    node = KS()
    with pytest.raises(Exception, match="can't over 1.0"):
        node.sample(
            model="m", positive="p", negative="n", latent_image={"samples": torch.zeros((1, 4, 8, 8))},
            start_denoise=0.5, denoise_increment=0.1, denoise_increment_steps=10,
        )


def test_unbound_sampler_errors():
    KS._sampler_fn = None
    node = KS()
    with pytest.raises(RuntimeError, match="set_sampler"):
        node.sample(
            model="m", positive="p", negative="n", latent_image={"samples": torch.zeros((1, 4, 8, 8))},
            start_denoise=0.0, denoise_increment=0.1, denoise_increment_steps=3,
        )


def test_set_sampler_overrides_the_lists():
    before = (KS._samplers, KS._schedulers)
    try:
        KS.set_sampler(lambda *a, **k: None, samplers=["euler"], schedulers=["karras"])
        req = KS.INPUT_TYPES()["required"]
        assert req["sampler_name"] == (["euler"],) and req["scheduler"] == (["karras"],)
    finally:
        KS._samplers, KS._schedulers = before


@pytest.mark.parametrize("text,skip", [("1,2,3", True), ("0, 4", False), ("7", True)])
def test_make_interpolation_state_list(text, skip):
    (got,) = pnodes.NODE_CLASS_MAPPINGS["Make Interpolation State List"]().create_options(text, skip)
    (want,) = jnodes.NODE_CLASS_MAPPINGS["Make Interpolation State List"]().create_options(text, skip)
    assert got.frame_indices == want.frame_indices and got.is_skip_list == want.is_skip_list
    assert [got.is_frame_skipped(i) for i in range(9)] == [want.is_frame_skipped(i) for i in range(9)]


@pytest.mark.parametrize("value", [0.0, 2.7, 41.99, [1.5, 2.2, 0.9], (3.9,)])
def test_float_to_int(value):
    got = pnodes.NODE_CLASS_MAPPINGS["VFI FloatToInt"]().convert(value)
    assert got == jnodes.NODE_CLASS_MAPPINGS["VFI FloatToInt"]().convert(value)


def _no_tooltips(schema):
    if isinstance(schema, dict):
        return {k: _no_tooltips(v) for k, v in schema.items() if k != "tooltip"}
    if isinstance(schema, (tuple, list)):
        return type(schema)(_no_tooltips(v) for v in schema)
    return schema


NEW_NODES = ["CAIN VFI", "Sepconv VFI", "Make Interpolation State List", "VFI FloatToInt", KS_NAME]


@pytest.mark.parametrize("name", NEW_NODES)
def test_input_types_equal_jax_node(name):
    port, ref = pnodes.NODE_CLASS_MAPPINGS[name], jnodes.NODE_CLASS_MAPPINGS[name]
    if name.endswith(" VFI"):
        assert _no_tooltips(port.INPUT_TYPES()) == _no_tooltips(ref.INPUT_TYPES()) and "TPU" not in str(port.INPUT_TYPES())
        assert port.INPUT_TYPES()["required"]["batch_size"][1]["default"] == (4 if name == "CAIN VFI" else 2)
    else:
        assert port.INPUT_TYPES() == ref.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY", "OUTPUT_NODE"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr


def test_registry_equals_jax_less_momo():
    want = list(jnodes.NODE_CLASS_MAPPINGS)  # since MoMo's port: the whole JAX registry
    assert list(pnodes.NODE_CLASS_MAPPINGS) == want and len(want) == 18
    assert pnodes.NODE_DISPLAY_NAME_MAPPINGS == {k: jnodes.NODE_DISPLAY_NAME_MAPPINGS[k] for k in want}
    assert list(pnodes.NODE_DISPLAY_NAME_MAPPINGS) == want
    for name in want:
        assert pnodes.NODE_CLASS_MAPPINGS[name].__name__ == jnodes.NODE_CLASS_MAPPINGS[name].__name__


def test_register_adds_a_node(monkeypatch):
    monkeypatch.setattr(pnodes, "NODE_CLASS_MAPPINGS", dict(pnodes.NODE_CLASS_MAPPINGS))
    monkeypatch.setattr(pnodes, "NODE_DISPLAY_NAME_MAPPINGS", dict(pnodes.NODE_DISPLAY_NAME_MAPPINGS))

    class Extra:
        pass

    pnodes.register("Extra VFI", Extra)
    pnodes.register("Other VFI", Extra, "Other (display)")
    assert pnodes.NODE_CLASS_MAPPINGS["Extra VFI"] is Extra and pnodes.NODE_DISPLAY_NAME_MAPPINGS["Extra VFI"] == "Extra VFI"
    assert pnodes.NODE_DISPLAY_NAME_MAPPINGS["Other VFI"] == "Other (display)"
