"""The port's serving-timeline simulator (``sim/serve_sim.py``, a copy of
the JAX package's) against the JAX one on the CPU: steps, metrics, each
step's decode and predicted bytes, the makespan and the whole artifact
(``to_dict``) equal; the planner==simulator decode-bytes cross-assert and
the coarse decode lowering as ``tests/test_serve.py:147-190`` and
``tests/test_batched_serve.py:268-279`` hold them; and the port's
``Engine`` (weights converted from the JAX init) against the port's
``simulate_serve`` through ``obs.metrics.assert_serve_parity`` across
modes, for one request and for none (``tests/test_obs.py:239-384``)."""
import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.models import transformer as jT
from repro.serve.schedule import ServeRequest as JServeRequest
from repro.sim import simulate_serve as jsimulate_serve
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import ExecutionMode as EM
from repro_torch.obs import metrics
from repro_torch.obs.metrics import assert_serve_parity
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.schedule import ServeRequest
from repro_torch.sim import ServeSimResult, simulate_serve

SMOKE = "starcoder2-7b"
TRAFFIC = [(6, 5, 0), (4, 3, 0), (9, 4, 1), (6, 6, 2), (5, 2, 5)]


def _both(arch, traffic, smoke=True, **kw):
    """(port, JAX) simulate_serve on the same requests; a ``mode`` in kw is
    given to each side as its own enum."""
    jkw = dict(kw)
    if kw.get("mode") is not None:
        jkw["mode"] = JMode(kw["mode"].value)
    got = simulate_serve(get_config(arch, smoke),
                         [ServeRequest(i, *t) for i, t in enumerate(traffic)],
                         **kw)
    want = jsimulate_serve(jregistry.get_config(arch, smoke),
                           [JServeRequest(i, *t)
                            for i, t in enumerate(traffic)], **jkw)
    return got, want


def _assert_same(got, want):
    assert isinstance(got, ServeSimResult)
    assert got.cycles == want.cycles and got.hbm_bytes == want.hbm_bytes
    assert [s.to_dict() for s in got.steps] == [s.to_dict()
                                                for s in want.steps]
    assert got.metrics == want.metrics
    assert got.cycle_metrics == want.cycle_metrics
    assert got.to_dict() == want.to_dict()
    assert got.result.trace.summary() == want.result.trace.summary()


@pytest.mark.parametrize("mode", [None] + list(EM))
@pytest.mark.parametrize("slots", [1, 3])
def test_simulate_serve_equals_jax(mode, slots):
    got, want = _both(SMOKE, TRAFFIC, slots=slots, mode=mode,
                      force_mode=mode is not None)
    _assert_same(got, want)
    assert got.energy().total_pj == want.energy().total_pj
    json.dumps(got.to_dict())


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
@pytest.mark.parametrize("mode", list(EM))
def test_decode_bytes_match_plan_per_registry_model(arch, mode):
    """test_serve.py:147: every decode step's simulated bytes are its
    DecodePlan's prediction, and equal the JAX simulator's."""
    got, want = _both(arch, [(24, 4, 0), (300, 3, 1)], smoke=False,
                      slots=2, mode=mode, force_mode=True)
    decode_steps = [s for s in got.steps if s.decoded]
    assert decode_steps
    for s in decode_steps:
        assert s.decode_hbm_bytes == s.predicted_decode_hbm_bytes > 0
    kv = decode_steps[-1].kv_lens
    assert (got.decode_plans[kv].total_hbm_bytes
            == decode_steps[-1].predicted_decode_hbm_bytes)
    _assert_same(got, want)


def test_decode_rewrite_cycles_match_plan():
    got, want = _both("qwen2-vl-2b", [(513, 2, 0)], smoke=False, slots=1)
    st = next(s for s in got.steps if s.decoded)
    tprefix = f"t{st.step}.dec."
    rw = sum(e.cycles for e in got.result.trace.events
             if e.kind == "rewrite" and e.tag.startswith(tprefix))
    assert rw == st.predicted_rewrite_cycles
    _assert_same(got, want)


def test_serve_mode_ordering_and_energy():
    """TILE < LAYER < NON on whisper's serving traffic (MHA), as in the
    JAX package; a crossmodal config has no decode and is refused."""
    with pytest.raises(ValueError):
        simulate_serve(get_config("vilbert-base"), [ServeRequest(0, 8, 2)],
                       slots=1)
    res = {m: _both("whisper-base", [(24, 3, 0), (40, 4, 1)], smoke=False,
                    slots=2, mode=m, force_mode=True) for m in EM}
    for got, want in res.values():
        _assert_same(got, want)
    cyc = {m: r[0].cycles for m, r in res.items()}
    assert cyc[EM.TILE_STREAM] < cyc[EM.LAYER_STREAM] < cyc[EM.NON_STREAM]
    assert res[EM.TILE_STREAM][0].energy().total_pj > 0


@pytest.mark.parametrize("kw", [{}, {"mode": EM.LAYER_STREAM,
                                     "force_mode": True},
                                {"calibration": {"ATTN": 1.7, "HBM": 1.3,
                                                 "CIM": 2.0}}])
def test_coarse_equals_fine(kw):
    """test_batched_serve.py:268-279: the coarse decode lowering gives the
    fine one's cycles, bytes, metrics and steps with fewer events, and
    equals the JAX coarse run."""
    fine, _ = _both(SMOKE, TRAFFIC, slots=3, **kw)
    coarse, jcoarse = _both(SMOKE, TRAFFIC, slots=3,
                            decode_lowering="coarse", **kw)
    assert coarse.cycles == fine.cycles
    assert coarse.hbm_bytes == fine.hbm_bytes
    assert coarse.metrics == fine.metrics
    assert coarse.cycle_metrics == fine.cycle_metrics
    for a, b in zip(fine.steps, coarse.steps):
        assert a.to_dict() == b.to_dict()
    assert len(coarse.result.trace.events) < len(fine.result.trace.events)
    _assert_same(coarse, jcoarse)
    with pytest.raises(ValueError, match="decode_lowering"):
        simulate_serve(get_config(SMOKE, True), [], decode_lowering="x")


# ---------------------------------------------------------------------------
# the port's Engine against the port's simulator
# ---------------------------------------------------------------------------

class _FakeClock:
    """Deterministic ``time.perf_counter`` stand-in (test_obs.py:282)."""

    def __init__(self, dt: float = 0.125) -> None:
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def model():
    cfg = get_config(SMOKE, smoke=True)
    params = jT.init(jax.random.PRNGKey(0),
                     jregistry.get_config(SMOKE, smoke=True))
    return cfg, transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")


def _req(rid, plen, new, arr=0):
    return Request(rid=rid, prompt=np.arange(1, plen + 1, dtype=np.int32),
                   max_new_tokens=new, arrival_step=arr)


@pytest.mark.parametrize("mode", [None, EM.TILE_STREAM, EM.LAYER_STREAM,
                                  EM.NON_STREAM])
def test_engine_sim_slo_parity_across_modes(model, mode):
    cfg, port = model
    kw = {} if mode is None else {"mode": mode}
    eng = Engine(cfg, port, slots=2, max_len=64, clock=_FakeClock(), **kw)
    traffic = [(6, 4, 0), (9, 3, 1), (5, 5, 3), (4, 2, 3)]
    for rid, (p, n, a) in enumerate(traffic):
        eng.submit(_req(rid, p, n, a))
    eng.run()
    stats = eng.stats()
    res = simulate_serve(cfg, [ServeRequest(rid, p, n, a)
                               for rid, (p, n, a) in enumerate(traffic)],
                         slots=2, mode=mode, force_mode=mode is not None)
    assert_serve_parity(stats, res.metrics)
    assert stats["requests"] == len(traffic)
    assert stats["wall"]["ttft"]["p50"] > 0
    # the engine's plans drive the simulator as well as its own planner
    own = simulate_serve(cfg, [ServeRequest(rid, p, n, a)
                               for rid, (p, n, a) in enumerate(traffic)],
                         slots=2, plan_fn=eng.plan_for,
                         decode_plan_fn=eng.decode_plan_for)
    assert_serve_parity(stats, own.metrics)


def test_engine_sim_parity_single_request(model):
    cfg, port = model
    eng = Engine(cfg, port, slots=1, max_len=64)
    eng.submit(_req(0, 5, 1))
    eng.run()
    res = simulate_serve(cfg, [ServeRequest(0, 5, 1)], slots=1)
    assert_serve_parity(eng.stats(), res.metrics)
    assert eng.stats()["tpot"]["max"] == 0.0
    (span,) = res.cycle_spans
    assert span.tokens == 1 and span.first_token == span.finish == res.cycles


def test_engine_sim_parity_zero_requests(model):
    cfg, port = model
    eng = Engine(cfg, port, slots=2, max_len=64)
    eng.run()
    res = simulate_serve(cfg, [], slots=2)
    assert res.num_steps == 0 and res.cycles == 0
    assert_serve_parity(eng.stats(), res.metrics)
    for metric in metrics.SPAN_METRICS:
        assert res.metrics[metric]["count"] == 0.0
    json.dumps(res.to_dict())


def test_parity_catches_divergence():
    res = simulate_serve(get_config(SMOKE, True), [ServeRequest(0, 6, 3)],
                         slots=1)
    good = res.metrics
    assert_serve_parity(good, good)
    with pytest.raises(AssertionError, match="tokens"):
        assert_serve_parity(dict(good, tokens=good["tokens"] + 1), good)
    with pytest.raises(AssertionError, match="ttft"):
        assert_serve_parity(dict(good, ttft=dict(good["ttft"], p99=123.0)),
                            good)
