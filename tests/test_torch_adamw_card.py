"""The trainer's AdamW kernel (``ops/csrc/adamw.cu``) on the card against its
plain PyTorch version, at the DES-Y1 3x2pt and LSST-Y10 6x2pt+N widths.

Marked ``card``: each test skips without a CUDA device.  This file imports
no JAX, so that it runs on a machine with the card alone:

    python -m pytest tests/test_torch_adamw_card.py --noconftest -m card

(from the repository's root, which holds ``chip_smoke.py``).

The kernel rounds every product, sum, quotient and root once, as the
PyTorch ops do, so it is held to them bit for bit: parameters, both
moments and the step count after every step.
"""

import pytest
import torch

import chip_smoke as C
from linna_tpu_torch import train as TR
from linna_tpu_torch.ops import adamw as AW
from linna_tpu_torch.ops import library as OL

pytestmark = pytest.mark.card

WIDTHS = {"des": (27, 457), "lsst": (40, 1560)}
STEPS = 5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card only")
    return torch.device("cuda")


def _problem(device, width, k, mu_dtype, seed=0):
    """chto_v2's parameters, an AdamW state, each step's leaf gradients and
    lr and wd per member (``chip_smoke.adamw_inputs``, 12f's problem)."""
    return C.adamw_inputs(device, *WIDTHS[width], k, mu_dtype, STEPS, seed)


def _equal(a_flat, a_state, b_flat, b_state, what):
    for name, a, b in zip(("params", "count", "mu", "nu"), (a_flat, *a_state),
                          (b_flat, *b_state)):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"{what}: {name} apart by {diff}")


@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_kernel_matches_the_plain_ops_bit_for_bit(card, width, k, mu_dtype):
    flat, st, grads, lr, wd = _problem(card, width, k, mu_dtype)
    flat_p, st_p = flat.clone(), TR.AdamWState(*(t.clone() for t in st))
    launches, plain = OL.launches["adamw"], OL.plain_calls["adamw"]
    for s, g in enumerate(grads):
        AW.adamw_(flat, g, st, lr, wd)
        AW.adamw_plain_(flat_p, g, st_p, lr, wd)
        torch.cuda.synchronize()
        _equal(flat, st, flat_p, st_p, f"step {s}")
        if s == 2:  # a member's optimizer reset, as a reload does
            TR.adamw_reset_(st, 1)
            TR.adamw_reset_(st_p, 1)
    assert OL.launches["adamw"] - launches == STEPS
    assert OL.plain_calls["adamw"] - plain == STEPS  # the plain side's calls
    # the concatenated gradient, a data group's, is the table of one segment
    cat = torch.cat([v.reshape(k, -1) for v in grads[0]], dim=1).to(torch.float32)
    AW.adamw_(flat, cat, st, lr, wd)
    AW.adamw_plain_(flat_p, cat, st_p, lr, wd)
    _equal(flat, st, flat_p, st_p, "concatenated gradient")


@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32])
def test_a_captured_step_equals_its_eager_twin(card, mu_dtype):
    """One step captured as a CUDA graph (the trainer's ``StepGraph``) and
    replayed, against the same steps run eagerly from the same state; each
    replay counts one launch."""
    from linna_tpu_torch.ops.graphs import StepGraph

    flat, st, grads, lr, wd = _problem(card, "des", 2, mu_dtype, seed=3)
    flat_e, st_e = flat.clone(), TR.AdamWState(*(t.clone() for t in st))
    g = grads[0]
    graph = StepGraph(lambda: AW.adamw_(flat, g, st, lr, wd), [flat, *st])
    _equal(flat, st, flat_e, st_e, "after the capture")  # the warm-up was put back
    launches = OL.launches["adamw"]
    for s in range(STEPS):
        graph.replay()
        AW.adamw_(flat_e, g, st_e, lr, wd)
        with torch.no_grad():
            lr.mul_(0.5)  # the graph reads lr in place, as _set_hypers writes it
        torch.cuda.synchronize()
        _equal(flat, st, flat_e, st_e, f"replay {s}")
    assert OL.launches["adamw"] - launches == 2 * STEPS


def test_the_kernel_refuses_a_gradient_on_the_host(card):
    flat, st, grads, lr, wd = _problem(card, "des", 2, torch.bfloat16)
    before = flat.clone()
    with pytest.raises(ValueError):
        AW.adamw_(flat, [v.cpu() for v in grads[0]], st, lr, wd)
    assert torch.equal(flat, before) and int(st.count.max()) == 0
