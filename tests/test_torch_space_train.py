"""The training step on the ``space`` axis of the port's ``parallel/`` (rows
split over devices) for the families without a splat, on logical replicas
of the CPU: AMT S, FILM, CAIN, Sepconv, IFRNet S, ATM base (global motion,
no ensemble), IFUnet and MoMo lite (``tests/torch_space_train_cases.py``
builds each as its one-device train test does).

One ``parallel.make_train_step`` step (L1, Adam 1e-4) of each at b1 x
128x64 f64 on a ``(1, 2)`` mesh (two bands of 64 rows) against the same
step on a ``(1, 1)`` mesh: the loss within ``LOSS_RTOL`` relative and each
gradient within ``GRAD_RTOL`` of its tensor's largest magnitude after
1e-12 absolute (a gradient that is 0 but for rounding, such as a bias
before a normalisation, is ~1e-18 in both). Every rule computes what the
op computes on the whole tensor, so in f64 the split is one device's
result up to the order of its sums, except where a family computes in f32
in every dtype: AMT's correlation (coordinates, gathered features and
dots), ATM's attention and MoMo's GroupNorm statistics. The tolerances are
~4x these gaps, measured at 2 and 4 torch threads (the worst tensor's):

=========  ============  =====================  ==========
family     loss          worst gradient         tolerance
=========  ============  =====================  ==========
AMT S      2.0e-16       6.3e-8 (f32 dots)      3e-7
FILM       0             0 (8.5e-16 raw)        1e-12
CAIN       0             0 (6.4e-15 raw)        1e-12
Sepconv    0             0 (4.1e-13 raw)        1e-12
IFRNet S   0             0 (1.2e-15 raw)        1e-12
ATM base   0             9.9e-7 (f32 attention) 4e-6
IFUnet     2.1e-16       0 (1.1e-14 raw)        1e-12
MoMo lite  7.6e-9        2.6e-5 (f32 stats)     1e-4
=========  ============  =====================  ==========

("raw": the gap with no absolute slack.) MoMo is held in f64, never
against an f32 one-device step with oneDNN on: its x8 mask's weight
gradient there is oneDNN's, ~0.12 of its largest magnitude from f64 on
this CPU (``ROADMAP.md``, Queue 3).

Then the contract for an op that has no row-band rule: a model whose
forward runs one (a running sum down the rows, the rows rolled round the
frame) raises at it through ``make_train_step`` on ``(1, 2)``, naming the
op and ``ROADMAP.md Queue 1 item 3``, and never falls back to a
data-parallel or one-device step.

``PYTHONPATH=.:tests python tests/test_torch_space_train.py`` prints the
gaps. No JAX in this file.
"""

import re

import pytest
import torch

import torch_space_train_cases as sc
from comfyui_frame_interpolation_tpu_torch import parallel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

HW = (128, 64)
GRAD_ATOL = 1e-12
# (loss relative, each gradient over its tensor's largest magnitude)
TOLERANCES = {
    "amt": (1e-13, 3e-7),
    "film": (1e-13, 1e-12),
    "cain": (1e-13, 1e-12),
    "sepconv": (1e-13, 1e-12),
    "ifrnet": (1e-13, 1e-12),
    "atm": (1e-13, 4e-6),
    "ifunet": (1e-13, 1e-12),
    "momo": (4e-8, 1e-4),
}


def _gaps(name):
    loss1, grads1 = sc.step(name, (1, 1), torch.float64, 1, HW)
    loss2, grads2 = sc.step(name, (1, 2), torch.float64, 1, HW)
    return abs(loss2 - loss1) / abs(loss1), *sc.rel_gap(grads2, grads1, GRAD_ATOL)


@pytest.mark.parametrize("name", list(TOLERANCES))
def test_split_step_matches_one_device_in_f64(name):
    loss_gap, grad_gap, worst = _gaps(name)
    loss_rtol, grad_rtol = TOLERANCES[name]
    assert loss_gap <= loss_rtol, loss_gap
    assert grad_gap <= grad_rtol, (worst, grad_gap)


class _RowOp(torch.nn.Module):
    """A 3x3 convolution, then an op over the rows that no family uses."""

    def __init__(self, op):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)
        self.op = op

    def forward(self, f0, f1, t):
        x = self.conv((f0 + f1).permute(0, 3, 1, 2))
        return self.op(x).permute(0, 2, 3, 1)


NO_RULES = {  # ops over the rows that no family uses, and the names their refusals give
    "cumsum": (lambda x: x.cumsum(2), "Tensor.cumsum"),
    "roll": (lambda x: torch.roll(x, 1, 2), "_VariableFunctionsClass.roll"),
}


@pytest.mark.parametrize("op", list(NO_RULES))
def test_a_training_step_on_the_space_axis_without_a_rule_raises(op):
    op_fn, name = NO_RULES[op]
    net = _RowOp(op_fn)
    mesh = parallel.make_mesh(2, devices=[sc.CPU] * 2)  # (1, 2): the space axis
    step = parallel.make_train_step(lambda n, f0, f1, t: n(f0, f1, t), torch.optim.Adam(net.parameters(), lr=sc.LR), mesh, net)
    f = torch.rand(2, 128, 64, 3)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    with pytest.raises(NotImplementedError, match=f"^{re.escape(name)} has no row-band rule: .*ROADMAP.md Queue 1 item 3"):
        step(f, f, torch.full((2,), 0.5), f)
    assert all(torch.equal(v, before[k]) for k, v in net.named_parameters())


if __name__ == "__main__":
    for threads in (2, 4):
        torch.set_num_threads(threads)
        for name in TOLERANCES:
            loss_gap, grad_gap, worst = _gaps(name)
            print(f"{threads} threads, {name}: loss {loss_gap:.3g}, gradient {grad_gap:.3g} at {worst}", flush=True)
