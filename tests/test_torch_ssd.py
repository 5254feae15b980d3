"""The port's SSD scan against the JAX package on the CPU: the plain
version ``blocked.ssd_chunked_plain`` (what the ``ssd_scan`` wrapper runs
on CPU tensors) against the Pallas kernel in interpret mode, the
sequential oracle and ``jnp_blocked.ssd_chunked_jnp``, both outputs; the
port's oracle against JAX's; ``ops.ssd`` against JAX's ``ops.ssd``; the
wrapper's host-side checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_blocked as JB
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import blocked, ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan

# B, S, H, P, N, chunk: tests/test_kernels.py::test_ssd_kernel_interpret
# (the last has a ragged S).
CASES = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 64),
         (1, 200, 3, 16, 8, 64)]


def _inputs(B, S, H, P, N, seed=0, slow=False):
    """The reference tests' distributions, drawn with numpy.  ``slow``:
    step sizes around 1e-3, so that the state carries across chunks."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    pre = rng.standard_normal((B, S, H)) - (7.0 if slow else 0.0)
    dt = np.log1p(np.exp(pre)).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, a, b, c


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    B, S, H, P, N, chunk = case
    arrs = _inputs(B, S, H, P, N)
    Sp = -(-S // chunk) * chunk
    pad = [(0, 0), (0, Sp - S)]
    x, dt, a, b, c = arrs
    want_y, want_s = jssd_scan(
        jnp.pad(x, pad + [(0, 0), (0, 0)]), jnp.pad(dt, pad + [(0, 0)]), a,
        jnp.pad(b, pad + [(0, 0)]), jnp.pad(c, pad + [(0, 0)]), chunk=chunk,
        seq_len=S, interpret=True)
    y, st = blocked.ssd_chunked_plain(*_torch(*arrs), chunk=chunk)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    _close(y, want_y[:, :S], 2e-3)
    _close(st, want_s, 2e-3)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_ref_and_jnp_blocked(case):
    B, S, H, P, N, chunk = case
    arrs = _inputs(B, S, H, P, N, seed=1)
    y, st = blocked.ssd_chunked_plain(*_torch(*arrs), chunk=chunk)
    ry, rs = jref.ref_ssd(*arrs, return_final_state=True)
    _close(y, ry, 1e-3)
    _close(st, rs, 1e-3)
    jy, js = JB.ssd_chunked_jnp(*arrs, chunk=chunk)
    _close(y, jy, 1e-3)
    _close(st, js, 1e-3)


def test_oracle_matches_jax_with_initial_state():
    arrs = _inputs(2, 37, 3, 8, 4, seed=2)
    s0 = np.random.default_rng(3).standard_normal((2, 3, 8, 4)).astype(
        np.float32)
    y, st = ref.ref_ssd(*_torch(*arrs), initial_state=torch.from_numpy(s0),
                        return_final_state=True)
    jy, js = jref.ref_ssd(*arrs, initial_state=s0, return_final_state=True)
    _close(y, jy, 1e-5)
    _close(st, js, 1e-5)
    assert torch.equal(ref.ref_ssd(*_torch(*arrs)), ref.ref_ssd(
        *_torch(*arrs), return_final_state=True)[0])


@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_chunk_changes_only_the_order_of_sums(chunk):
    """The kernel walks 64-row chunks whatever chunk it is given: the
    function must not depend on the chunk (slow decay: the state carried
    between chunks matters)."""
    arrs = _torch(*_inputs(1, 150, 2, 8, 8, seed=4, slow=True))
    y, st = blocked.ssd_chunked_plain(*arrs, chunk=chunk)
    ry, rs = ref.ref_ssd(*arrs, return_final_state=True)
    _close(y, ry, 1e-4)
    _close(st, rs, 1e-4)


def test_ops_ssd_matches_jax_and_takes_the_plain_version_on_cpu():
    arrs = _inputs(1, 70, 4, 16, 8, seed=5)
    before = ssd_scan.launches
    y, st = ops.ssd(*_torch(*arrs), chunk=32)
    assert ssd_scan.launches == before
    want = jops.ssd(*arrs, chunk=32)
    _close(y, want[0], 1e-4)
    _close(st, want[1], 1e-4)
    py, ps = blocked.ssd_chunked_plain(*_torch(*arrs), chunk=32)
    assert torch.equal(y, py) and torch.equal(st, ps)


def test_bf16_inputs_give_bf16_y_and_f32_state():
    x, dt, a, b, c = _torch(*_inputs(1, 40, 2, 8, 4, seed=6))
    y, st = ssd_scan(x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(),
                     chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    ry, rs = ref.ref_ssd(x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(),
                         return_final_state=True)
    torch.testing.assert_close(y.float(), ry.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(st, rs, atol=1e-4, rtol=1e-4)


def test_cuda_only_checks_raise_before_any_launch():
    """Tensors the kernel does not take are refused on the host (reached
    through tensors on the 'meta' device, which is not the CPU)."""
    x = torch.empty((1, 8, 2, 4), device="meta")
    bc = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan(x, torch.empty((1, 8, 2), device="meta"),
                 torch.empty((2,), device="meta"), bc, bc)


# ---- the bf16 kernel's four stages (blocked.ssd_four_stage_plain)

def _mamba2_inputs(B, S, H, P, N, seed):
    """Mamba-2's initial ranges (arXiv:2405.21060): head h steps around
    exp(lerp(log 1e-3, log 1e-1, h / (H - 1))) and decays at a rate A in
    [1, 16], so the slow heads carry their state across many chunks."""
    rng = np.random.default_rng(seed)
    step = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    bias = step + np.log(-np.expm1(-step))                 # softplus^-1
    pre = rng.standard_normal((B, S, H)) * 0.5 + bias
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(pre)).astype(np.float32)
    a = (-(1 + 15 * rng.random(H))).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, a, b, c


FOUR_TOL = 1e-5
# CASES, a ragged S over several chunks, and Mamba-2's slow decay
FOUR_STAGE_INPUTS = (
    [(case, "ref", 0) for case in CASES]
    + [((1, 333, 3, 16, 8, 64), "ref", 9),
       ((2, 300, 4, 32, 16, 64), "mamba2", 10),
       ((1, 700, 6, 16, 32, 128), "mamba2", 11)])


def _four_stage_inputs(case, kind, seed):
    B, S, H, P, N, _ = case
    if kind == "mamba2":
        return _mamba2_inputs(B, S, H, P, N, seed)
    return _inputs(B, S, H, P, N, seed=seed)


@pytest.mark.parametrize("L", [64, 128])
@pytest.mark.parametrize("case,kind,seed", FOUR_STAGE_INPUTS)
def test_four_stage_matches_ref(case, kind, seed, L):
    """Every stage over all chunks at once, the state passed along after:
    the same function as the sequential oracle, at two chunk lengths."""
    arrs = _four_stage_inputs(case, kind, seed)
    y, st = blocked.ssd_four_stage_plain(*_torch(*arrs), chunk=L)
    ry, rs = jref.ref_ssd(*arrs, return_final_state=True)
    _close(y, ry, FOUR_TOL)
    _close(st, rs, FOUR_TOL)


@pytest.mark.parametrize("case,kind,seed", FOUR_STAGE_INPUTS[:3]
                         + FOUR_STAGE_INPUTS[4:5])
def test_four_stage_matches_pallas_interpret(case, kind, seed):
    B, S, H, P, N, chunk = case
    x, dt, a, b, c = _four_stage_inputs(case, kind, seed)
    Sp = -(-S // chunk) * chunk
    pad = [(0, 0), (0, Sp - S)]
    want_y, want_s = jssd_scan(
        jnp.pad(x, pad + [(0, 0), (0, 0)]), jnp.pad(dt, pad + [(0, 0)]), a,
        jnp.pad(b, pad + [(0, 0)]), jnp.pad(c, pad + [(0, 0)]), chunk=chunk,
        seq_len=S, interpret=True)
    y, st = blocked.ssd_four_stage_plain(*_torch(x, dt, a, b, c))
    _close(y, want_y[:, :S], FOUR_TOL)
    _close(st, want_s, FOUR_TOL)


def test_mamba2_inputs_need_the_carry():
    """With Mamba-2's ranges the state carried into a chunk moves y there by
    far more than the tolerance: the second chunk's y computed from a zero
    state (a dropped carry) fails the comparison."""
    x, dt, a, b, c = _torch(*_mamba2_inputs(1, 128, 4, 16, 16, seed=12))
    y, _ = blocked.ssd_four_stage_plain(x, dt, a, b, c)
    y2, _ = blocked.ssd_four_stage_plain(x[:, 64:], dt[:, 64:], a,
                                         b[:, 64:], c[:, 64:])
    gap = (y[:, 64:] - y2).abs() / (FOUR_TOL * (1 + y[:, 64:].abs()))
    assert gap.max() > 100
