"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), built at first
use by :mod:`.build` and bound with :mod:`ctypes`. Importing this package
builds nothing."""
