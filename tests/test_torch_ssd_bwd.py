"""The port's training backwards that the SSM, MoE and MLA families added,
against the JAX package on the CPU: ``SSDScanFn`` (the ``ssd_scan``
wrapper under autograd; its backward ``ssd_scan_bwd`` takes the plain
version ``blocked.ssd_scan_bwd_plain`` on CPU tensors) against ``jax.vjp``
of ``jnp_blocked.ssd_chunked_jnp`` (what the JAX training path
differentiates), and the plain backward against torch's autograd of
``blocked.ssd_chunked_plain``; the flash backward at MLA's latent widths
(q/k 576, v 512, MQA, causal) against ``jax.grad`` of the JAX
``flash_mem_efficient``.  Each gradient is held within 1e-4 of its largest
value.  Inputs are made with numpy from a seed; the CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_vjp as jvjp
from repro.kernels import jnp_blocked as JB
from repro.kernels import ref as jref
from repro_torch.kernels import blocked, ops
from repro_torch.kernels.flash_vjp import FlashAttentionFn
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan, ssd_scan_bwd

TOL = 1e-4
NAMES = ("x", "dt", "a", "b", "c")


def _close_scaled(name, got, want, tol=TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    assert got.shape == want.shape, name
    assert np.isfinite(want).all(), f"{name}: the reference is not finite"
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{name}: max |diff| {err:.2e} of max |value|"


def _ssd_inputs(B, S, H, P, N, kind, seed):
    """"ref": the reference tests' distributions (tests/test_kernels.py);
    "slow": step sizes around 1e-3, so that the state carries across
    chunks; "mamba2": Mamba-2's initial ranges (arXiv:2405.21060), head h
    stepping around exp(lerp(log 1e-3, log 1e-1, h / (H - 1))), A in
    [1, 16]."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    if kind == "mamba2":
        step = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
        pre = rng.standard_normal((B, S, H)) * 0.5 + step + np.log(
            -np.expm1(-step))
        a = (-(1 + 15 * rng.random(H))).astype(np.float32)
    else:
        pre = rng.standard_normal((B, S, H)) - (7.0 if kind == "slow" else 0.0)
        a = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    dt = np.log1p(np.exp(pre)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dstate = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, a, b, c), dy, dstate


# (B, S, H, P, N, chunk), input kind, seed, with d(final state).  The
# chunks keep exp(LD_t - LD_s) finite above the diagonal, which the JAX
# function evaluates and masks (jnp.where): its gradient is NaN where that
# overflows; the port's never evaluates it.
SSD_CASES = [
    ((1, 128, 2, 32, 16, 16), "ref", 0, False),
    ((1, 200, 3, 16, 8, 32), "ref", 1, True),       # ragged last chunk
    ((2, 96, 2, 16, 8, 48), "ref", 2, False),       # chunk not a power of 2
    ((2, 256, 4, 32, 16, 64), "slow", 3, True),     # state across chunks
    ((1, 300, 4, 32, 16, 16), "mamba2", 4, True),   # ragged, Mamba-2 ranges
    ((1, 64, 2, 8, 4, 64), "slow", 5, False),       # one chunk
]


@pytest.mark.parametrize("case,kind,seed,with_state", SSD_CASES)
def test_ssd_grad_matches_jax(case, kind, seed, with_state):
    """The gradient of the port's ``ssd_scan`` under autograd (SSDScanFn)
    against ``jax.vjp`` of ``ssd_chunked_jnp``, with respect to x, dt, a,
    b and c, for dy and (``with_state``) a non-zero d(final state)."""
    B, S, H, P, N, chunk = case
    arrs, dy, dstate = _ssd_inputs(B, S, H, P, N, kind, seed)
    if not with_state:
        dstate = np.zeros_like(dstate)
    _, vjp = jax.vjp(lambda *a: JB.ssd_chunked_jnp(*a, chunk=chunk), *arrs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, state = ssd_scan(*xs, chunk=chunk)
    assert y.grad_fn is not None and state.grad_fn is not None
    loss = (y * torch.from_numpy(dy)).sum()
    if with_state:
        loss = loss + (state * torch.from_numpy(dstate)).sum()
    got = torch.autograd.grad(loss, xs)
    for name, g, w in zip(NAMES, got, want):
        _close_scaled(f"d{name}", g, w)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("case,kind,seed,with_state", SSD_CASES[:4])
def test_plain_bwd_matches_autograd(case, kind, seed, with_state, chunk):
    """``ssd_scan_bwd_plain`` (the kernel's stages; chunk 64 is the
    kernel's) against torch's autograd of ``ssd_chunked_plain`` at the
    case's own chunk: the function does not depend on the chunk."""
    B, S, H, P, N, own = case
    arrs, dy, dstate = _ssd_inputs(B, S, H, P, N, kind, seed)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, state = blocked.ssd_chunked_plain(*xs, chunk=own)
    ds = torch.from_numpy(dstate) if with_state else None
    loss = (y * torch.from_numpy(dy)).sum()
    if with_state:
        loss = loss + (state * ds).sum()
    want = torch.autograd.grad(loss, xs)
    got = blocked.ssd_scan_bwd_plain(*[torch.from_numpy(a) for a in arrs],
                                     torch.from_numpy(dy), ds, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype
        _close_scaled(f"d{name}", g.detach(), w.detach())


@pytest.mark.parametrize("case,kind,seed,with_state", SSD_CASES)
def test_split_bwd_matches_jax_and_plain(case, kind, seed, with_state):
    """``ssd_scan_bwd_split`` (the tc route's products, f32 operands as
    bf16 hi + lo, in chunks of 64) against ``jax.vjp`` of
    ``ssd_chunked_jnp`` at the case's own chunk and against
    ``ssd_scan_bwd_plain``: ragged last chunks, slow decay, d(final state)
    null and given, f32 inputs."""
    B, S, H, P, N, chunk = case
    arrs, dy, dstate = _ssd_inputs(B, S, H, P, N, kind, seed)
    ds = dstate if with_state else np.zeros_like(dstate)
    _, vjp = jax.vjp(lambda *a: JB.ssd_chunked_jnp(*a, chunk=chunk), *arrs)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    ts = [torch.from_numpy(a) for a in arrs]
    dst = torch.from_numpy(dstate) if with_state else None
    got = blocked.ssd_scan_bwd_split(*ts, torch.from_numpy(dy), dst)
    plain = blocked.ssd_scan_bwd_plain(*ts, torch.from_numpy(dy), dst,
                                       chunk=chunk)
    for name, g, w, p_ in zip(NAMES, got, want, plain):
        assert g.dtype == p_.dtype and g.shape == p_.shape
        _close_scaled(f"d{name}", g, w)
        _close_scaled(f"d{name} (plain)", g, p_)


@pytest.mark.parametrize("dtype,P,N,route", [
    (torch.bfloat16, 64, 128, "tc"),      # mamba2-780m
    (torch.bfloat16, 128, 16, "tc"),      # hymba-1.5b
    (torch.bfloat16, 8, 8, "tc"),
    (torch.bfloat16, 136, 16, "simt"),    # wider than the tc tiles
    (torch.bfloat16, 64, 132, "simt"),
    (torch.bfloat16, 60, 16, "simt"),     # not a multiple of 8
    (torch.bfloat16, 64, 4, "simt"),
    (torch.float32, 64, 128, "simt"),     # f32: the parity path
])
def test_ssd_bwd_route(dtype, P, N, route):
    """The SSD backward's route rule (the library's, read on the card by
    chip_smoke.py, must agree): tc for bf16 with P and N multiples of 8 up
    to 128, simt otherwise."""
    assert blocked.ssd_bwd_route(dtype, P, N) == route


def test_ssd_grad_of_y_alone_and_bf16_dtypes():
    """A loss on y alone (the training case: ``ssm_forward`` drops the
    state) passes no state gradient; bf16 inputs get bf16 gradients for
    x, b, c and f32 ones for dt and a (the kernel's dtypes)."""
    arrs, dy, _ = _ssd_inputs(1, 80, 2, 16, 8, "ref", 6)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, _ = SSDScanFn.apply(*xs, 16)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), xs)
    want = ssd_scan_bwd(*[torch.from_numpy(a) for a in arrs],
                        torch.from_numpy(dy), None, chunk=16)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, msg=name)
    lo = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        lo[i] = lo[i].bfloat16()
    grads = ssd_scan_bwd(*lo, torch.from_numpy(dy).bfloat16(), None, chunk=16)
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32, torch.bfloat16,
                                        torch.bfloat16]


def test_ops_ssd_under_grad_runs_the_backward():
    """``ops.ssd`` (what ``ssm_forward`` calls) records SSDScanFn under
    autograd and the plain scan under no_grad."""
    arrs, _, _ = _ssd_inputs(1, 40, 2, 8, 4, "ref", 7)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, _ = ops.ssd(*xs, chunk=16)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    with torch.no_grad():
        y2, _ = ops.ssd(*xs, chunk=16)
    assert y2.grad_fn is None
    torch.testing.assert_close(y.detach(), y2)


# ---- the flash backward at MLA's latent widths (the wide route)

# B, Hq, Sq, Sk, hd, hdv, causal, q_offset
WIDE_CASES = [
    (1, 4, 64, 64, 576, 512, True, 0),     # deepseek-v3's widths, MQA
    (1, 3, 50, 70, 576, 512, True, 20),    # ragged, query offset
    (2, 2, 40, 40, 192, 160, False, 0),    # just over 128
]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_flash_grad_matches_jax(case):
    """``FlashAttentionFn`` (MQA over one latent kv head, the backward the
    wide route runs on the card) against ``jax.grad`` of the JAX
    ``flash_mem_efficient`` (its custom VJP ``_flash_bwd``), dq, dk, dv
    within 1e-4 of their largest values."""
    B, H, Sq, Sk, hd, hdv, causal, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q = (rng.standard_normal((B, H, Sq, hd)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, 1, Sk, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, 1, Sk, hdv)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B, H, Sq, hdv)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jvjp.flash_mem_efficient(
        *a, causal=causal, q_offset=off, block_k=32) * cot),
        argnums=(0, 1, 2))(q, k, v)
    xs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*xs, causal, 0, off, 32)
    got = torch.autograd.grad(out, xs, torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        _close_scaled(f"d{name}", g, w)
    assert blocked.flash_bwd_route(torch.bfloat16, hd, hdv) == "wide"
    assert blocked.flash_bwd_route(torch.float32, hd, hdv) == "wide"


@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,heads", [
    (128, 1, 1024, 1024, 64),     # deepseek-v3's prefill: 8 MiB a head
    (128, 1, 4096, 4096, 4),
    (4, 1, 64, 64, 4),            # every head at once
    (128, 1, 32768, 32768, 1),    # at least one
])
def test_wide_route_head_groups(Hq, Hkv, Sq, Sk, heads):
    """The wide route's head groups keep P and dS (4 bytes an element:
    f32, or bf16 hi + lo) within ``BWD_WIDE_SCRATCH``."""
    got = blocked.flash_bwd_wide_heads(1, Hq, Hkv, Sq, Sk)
    assert got == heads
    assert (got == 1 or 2 * got * Sq * (-(-Sk // 64) * 64) * 4
            <= blocked.BWD_WIDE_SCRATCH)


# B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, q_offset, heads a group:
# narrow widths over 128 (the wide route), against the reference attention
WIDE_SPLIT_CASES = [
    (1, 4, 1, 130, 130, 144, 136, True, 0, 0, None),   # causal, ragged spans
    (1, 4, 1, 96, 160, 144, 136, True, 0, 64, 1),      # offset, one head a group
    (2, 6, 2, 100, 100, 136, 144, False, 40, 0, 2),    # GQA, window, 2 groups
    (1, 3, 1, 70, 50, 144, 136, False, 16, 40, 2),     # rows with no live key
    (1, 20, 1, 64, 64, 136, 136, True, 0, 0, 20),      # 16 head slices
]


def _ref_attention(q, k, v, *, causal, window, q_offset):
    """``ref_attention``'s function (its mask and -1e30 fill, softmax over
    the keys) with v wider or narrower than q/k."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, Hq // Hkv, Sq, hd)
    s = jnp.einsum("bhgqd,bhkd->bhgqk", qf, k) * hd ** -0.5
    mask = jref._attn_mask(Sq, Sk, causal, window, q_offset)
    if mask is not None:
        s = jnp.where(mask[None, None, None], s, jref.NEG_INF)
    o = jnp.einsum("bhgqk,bhkd->bhgqd", jax.nn.softmax(s, axis=-1), v)
    return o.reshape(B, Hq, Sq, v.shape[-1])


@pytest.mark.parametrize("case", WIDE_SPLIT_CASES)
def test_wide_split_matches_jax(case):
    """``flash_attention_bwd_wide_split`` (the wide route's bf16 kernels'
    order of sums: head groups, head slices, spans summed apart; P and dS
    as hi + lo) against ``jax.grad`` of the reference attention
    (``ref_attention``'s function: a row with no live key attends
    uniformly to every key, the port's rule), dq, dk, dv within 1e-4 of their largest
    values, and against ``flash_attention_bwd_plain``."""
    B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, off, heads = case
    rng = np.random.default_rng(sum(case[:7]))
    q = (rng.standard_normal((B, Hq, Sq, hd)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Sk, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, Hkv, Sk, hdv)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B, Hq, Sq, hdv)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(_ref_attention(
        *a, causal=causal, window=window, q_offset=off) * cot),
        argnums=(0, 1, 2))(q, k, v)
    qt, kt_, vt, dout = (torch.from_numpy(t) for t in (q, k, v, cot))
    kw = dict(causal=causal, window=window, q_offset=off)
    out, lse = blocked.flash_attention_plain(qt, kt_, vt, return_lse=True,
                                             **kw)
    got = blocked.flash_attention_bwd_wide_split(qt, kt_, vt, out, lse, dout,
                                                 heads=heads, **kw)
    plain = blocked.flash_attention_bwd_plain(qt, kt_, vt, out, lse, dout,
                                              **kw)
    for name, g, w, p_ in zip("qkv", got, want, plain):
        _close_scaled(f"d{name}", g, w)
        _close_scaled(f"d{name} (plain)", g, p_)


@pytest.mark.parametrize("gc,splits", [(64, 16), (16, 16), (4, 4), (1, 1),
                                       (100, 16)])
def test_wide_route_splits(gc, splits):
    """The wide route's dK/dV blocks a key tile: the group's heads in at
    most 16 even slices, every head in exactly one."""
    assert blocked.flash_bwd_wide_splits(gc) == splits
    heads = [h for s in range(splits)
             for h in range(s * gc // splits, (s + 1) * gc // splits)]
    assert heads == list(range(gc))
