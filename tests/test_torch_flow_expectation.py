"""ASpan's flow expectation (ops/flow_expectation.py) on the CPU: the plain
version is FlowHead's dense chain as it was, the recomputing backward
equals autograd through it, and the wrapper refuses what the card's
kernel cannot take. The kernel itself is compared with the plain version
on the card (tests/test_torch_gpu.py). Each test takes well under a
second."""

import numpy as np
import pytest
import torch

from detectorfreesfm_tpu_torch.models import aspan
from detectorfreesfm_tpu_torch.ops import flow_expectation as fe

HW = (5, 7)  # a 35-cell grid
L = HW[0] * HW[1]


def _qk(seed=0, b=2, l=L, d=64, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, scale, (b, l, d))).to(dtype)
            for _ in "qk"]


def test_grid_xy_is_col_then_row():
    grid = fe.grid_xy(L, HW[1], "cpu")
    assert grid.dtype == torch.float32 and grid.shape == (L, 2)
    assert grid[9].tolist() == [2.0, 1.0]          # 9 = 1 x 7 + 2
    assert grid[-1].tolist() == [HW[1] - 1.0, HW[0] - 1.0]


def test_flow_head_is_the_dense_chain_bit_for_bit():
    """FlowHead's flow equals the chain it ran before the kernel: the
    fp32 similarity by bmm, divided by 8 in place, its softmax, one
    product with the cell coordinates, minus the cells, plus the
    residual."""
    torch.manual_seed(0)
    head = aspan.FlowHead(256).eval()
    g = torch.Generator().manual_seed(1)
    x, src = (torch.randn(2, L, 256, generator=g) for _ in "xs")
    with torch.no_grad():
        got = head(x, src, HW)
        sim = torch.bmm(head.proj_q(x).float(),
                        head.proj_k(src).float().transpose(1, 2))
        p = torch.softmax(sim.div_(8.0), dim=-1)
        grid = fe.grid_xy(L, HW[1], x.device)
        want = torch.matmul(p, grid) - grid + head.delta(x).float()
    assert torch.equal(got, want)


def test_cpu_runs_the_plain_version_and_launches_nothing():
    q, k = _qk(1)
    before = dict(fe.launches)
    assert torch.equal(fe.flow_expectation(q, k, HW[1]),
                       fe.flow_expectation_plain(q, k, HW[1]))
    assert fe.launches == before


def test_recomputing_backward_equals_autograd():
    """float64, so that the two orders of summation agree to 1e-10: the
    hand formula for dq and dk against autograd through the dense chain,
    with logits of a few units (a peaked but not one-hot softmax)."""
    q, k = _qk(2, scale=0.6, dtype=torch.float64)
    g = _qk(3, d=2, dtype=torch.float64)[0]
    grid = fe.grid_xy(L, HW[1], "cpu").double()
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    p = torch.softmax(torch.bmm(qa, ka.transpose(1, 2)) * fe.SCALE, dim=-1)
    (torch.matmul(p, grid) * g).sum().backward()

    dq, dk = fe.flow_expectation_grads(q, k, HW[1], g)
    np.testing.assert_allclose(dq.numpy(), qa.grad.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(dk.numpy(), ka.grad.numpy(), rtol=0,
                               atol=1e-10)
    assert qa.grad.abs().max() > 1e-2 and ka.grad.abs().max() > 1e-2


def test_recomputing_backward_in_fp32():
    """The same in fp32 against autograd through the plain version, as
    the card's Function computes it: within 2e-5 of the gradients'
    largest value (fp32 sums over 35 keys in another order)."""
    q, k = _qk(4, scale=0.6)
    g = _qk(5, d=2)[0]
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    (fe.flow_expectation_plain(qa, ka, HW[1]) * g).sum().backward()
    dq, dk = fe.flow_expectation_grads(q, k, HW[1], g)
    for got, want in ((dq, qa.grad), (dk, ka.grad)):
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()


@pytest.mark.parametrize("case", ["dtype", "bf16", "width", "layout",
                                  "shape", "grid"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    q, k = _qk(6)
    w = HW[1]
    match = {"dtype": "float32", "bf16": "float32", "width": "width 64",
             "layout": "contiguous", "shape": "one shape",
             "grid": "is not h x"}[case]
    if case == "dtype":
        q, k = q.double(), k.double()
    elif case == "bf16":
        q = q.bfloat16()
    elif case == "width":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    elif case == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "shape":
        k = k[:, :-1].contiguous()
    else:
        w = 6
    with pytest.raises(ValueError, match=match):
        fe.flow_expectation(q, k, w)
