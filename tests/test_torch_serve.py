"""The port's BatchedServer: the reference's scheduler cases
(``tests/test_serve.py``) run against the port, and the port's tokens held
equal to the reference server's for the same weights and prompts.

Weights come from the reference's ``model.init`` through
``params_from_jax``; prompts from numpy seeds. Greedy tokens are compared
exactly: the logits agree to ~1e-6 relative (``tests/test_torch_models.py``),
far inside the gaps between top-1 and top-2 logits of these prompts.
"""

import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.scheduler import BatchedServer as JServer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like  # noqa: E402
from repro_torch.data.tokenizer import GeoTokenizer  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import BatchedServer  # noqa: E402


_TOK = GeoTokenizer(PORTO_BBOX, order=6)


def _setup(arch="internlm2-1.8b", **over):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jp = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def internlm():
    return _setup()


@pytest.mark.parametrize("arch,over", [("internlm2-1.8b", {}),
                                       ("qwen3-8b", {"n_kv_heads": 2}),
                                       ("granite-20b", {}),
                                       ("minicpm3-4b", {}),
                                       ("qwen2-moe-a2.7b", {}),
                                       ("arctic-480b", {}),
                                       ("mamba2-130m", {}),
                                       ("zamba2-1.2b", {}),
                                       ("whisper-medium", {}),
                                       ("pixtral-12b", {}),
                                       ("spatial-lm", {"vocab": _TOK.vocab})])
def test_tokens_match_reference_server(arch, over):
    """Every family: the same weights and prompts give the reference
    server's tokens. Waves are uneven (prompts of 3-13 tokens, three slots),
    so the SSM families also carry the reference's right-pad approximation;
    whisper and pixtral are served text only (cross-attention over the zero
    cache, no patches), as the reference serves them. spatial-lm serves
    tokenized Porto trips at the tokenizer's vocab, as
    ``examples/serve_lm.py`` does."""
    jcfg, tcfg, jp, tp = _setup(arch, **over)
    rng = np.random.default_rng(11)
    lens = rng.integers(3, 14, 6)
    if arch == "spatial-lm":
        mat = _TOK.encode_trajectories(porto_taxi_like(6, seed=9), 64)
        prompts = [mat[i][mat[i] > 0][:int(n)].astype(np.int32) for i, n in enumerate(lens)]
    else:
        prompts = [rng.integers(3, tcfg.vocab, int(n)).astype(np.int32) for n in lens]
    news = [int(n) for n in rng.integers(2, 9, 6)]
    out = []
    for cls, cfg, params in ((JServer, jcfg, jp), (BatchedServer, tcfg, tp)):
        srv = cls(cfg, params, max_batch=3, max_len=48)
        for i, (p, n) in enumerate(zip(prompts, news)):
            srv.submit(p, max_new_tokens=n, rid=i)
        out.append({r.rid: r.out_tokens for r in srv.run()})
    assert out[1] == out[0]
    assert len(out[1]) == 6


def test_scheduler_drains_queue(internlm, rng):
    _, cfg, _, params = internlm
    srv = BatchedServer(cfg, params, max_batch=3, max_len=64)
    for i, n in enumerate(rng.integers(3, 12, 7)):
        srv.submit(rng.integers(3, cfg.vocab, int(n)), max_new_tokens=6, rid=i)
    done = srv.run()
    assert len(done) == 7
    assert {r.rid for r in done} == set(range(7))
    for r in done:
        assert 1 <= len(r.out_tokens) <= 6
        assert r.t_first >= r.t_submit


def test_admission_wave_preserves_inflight_slots(internlm, rng):
    """Admitting wave 2 mid-decode must not clobber wave 1's cache rows:
    both outputs equal the same requests served with no co-tenant."""
    _, cfg, _, params = internlm
    pa = rng.integers(3, cfg.vocab, 9).astype(np.int32)
    pb = rng.integers(3, cfg.vocab, 5).astype(np.int32)

    def alone(prompt, n):
        srv = BatchedServer(cfg, params, max_batch=2, max_len=64)
        srv.submit(prompt, max_new_tokens=n)
        return srv.run()[0].out_tokens

    srv = BatchedServer(cfg, params, max_batch=2, max_len=64)
    a = srv.submit(pa, max_new_tokens=10)
    srv._fill_slots()
    srv._decode_once()
    srv._decode_once()                      # A is mid-generation
    mid = list(a.out_tokens)
    assert len(mid) == 3
    b = srv.submit(pb, max_new_tokens=6)
    done = srv.run()
    assert {r.rid for r in done} == {a.rid, b.rid}
    assert a.out_tokens[: len(mid)] == mid
    assert a.out_tokens == alone(pa, 10)
    assert b.out_tokens == alone(pb, 6)


def test_rids_unique_after_queue_drains(internlm, rng):
    _, cfg, _, params = internlm
    srv = BatchedServer(cfg, params, max_batch=2, max_len=64)
    prompts = [rng.integers(3, cfg.vocab, 5).astype(np.int32) for _ in range(4)]
    first = [srv.submit(p, max_new_tokens=3) for p in prompts[:2]]
    done = srv.run()                        # queue drains to empty
    second = [srv.submit(p, max_new_tokens=3) for p in prompts[2:]]
    done += srv.run()
    rids = [r.rid for r in first + second]
    assert len(set(rids)) == 4, rids
    assert {r.rid for r in done} == set(rids)


def test_cache_end_stops_a_request(internlm, rng):
    """A request stops when its slot reaches the end of the cache."""
    _, cfg, _, params = internlm
    srv = BatchedServer(cfg, params, max_batch=1, max_len=16)
    srv.submit(rng.integers(3, cfg.vocab, 10).astype(np.int32), max_new_tokens=100)
    (r,) = srv.run()
    assert len(r.out_tokens) == 16 - 10
    assert r.done


def test_scheduler_uses_monotonic_clock_and_obs(internlm, monkeypatch, rng):
    """Timestamps come from perf_counter (never wall-clock ``time.time``),
    and TTFT / total latency land in the port's obs histograms."""

    class _NoWallClock:
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def time():
            raise AssertionError("scheduler must not read wall-clock time")

    monkeypatch.setattr("repro_torch.serve.scheduler.time", _NoWallClock)
    _, cfg, _, params = internlm
    srv = BatchedServer(cfg, params, max_batch=2, max_len=64)
    obs.enable()
    try:
        for i in range(3):
            srv.submit(rng.integers(3, cfg.vocab, 4 + i), max_new_tokens=3)
        done = srv.run()
    finally:
        obs.disable()
    assert len(done) == 3
    for r in done:
        assert r.t_done >= r.t_first >= r.t_submit > 0.0
    assert obs.get_registry().histogram("serve.ttft_s").count == 3
    assert obs.get_registry().histogram("serve.latency_s").count == 3
    assert "p50" in obs.percentiles("serve.latency_s")


def test_server_is_freed_without_the_cycle_collector(internlm, rng):
    """Admission waves leave no reference cycle: a deleted server (and the
    caches it holds on the card) goes at once, not at the next collection,
    so the next model can have the memory."""
    import gc
    import weakref

    _, cfg, _, params = internlm
    srv = BatchedServer(cfg, params, max_batch=2, max_len=32)
    for n in (4, 7, 5):
        srv.submit(rng.integers(3, cfg.vocab, n).astype(np.int32), max_new_tokens=3)
    srv.run()
    ref = weakref.ref(srv)
    gc.disable()
    try:
        del srv
        assert ref() is None
    finally:
        gc.enable()
