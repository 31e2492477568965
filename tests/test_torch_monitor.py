"""apex_tpu_torch.monitor and the engine's telemetry on the CPU, against
apex_tpu.monitor and JAX's engine.

The monitor modules get the same inputs on both sides (seeded numpy
streams, one fake monotonic clock a side) and must give equal outputs:
event records, Chrome traces, request spans, SLO reports, meter ledgers,
JSONL sinks with rotation, registry text and merged snapshots. The engines
(tiny fp32 GPT, JAX's weights carried across with ``params_from_numpy``)
serve the same requests with every telemetry piece on, and their event
sequences, sink records, registry counters and ``stats()`` must agree on
every field that is not a time.
"""

import itertools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.monitor import events as jev
from apex_tpu.monitor import metrics as jmetrics
from apex_tpu.monitor import meter as jmeter
from apex_tpu.monitor import registry as jreg
from apex_tpu.monitor import sink as jsink
from apex_tpu.monitor import slo as jslo
from apex_tpu.monitor.hist import Histogram as JHistogram
from apex_tpu.serve import InferenceEngine as JEngine
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import ServeConfig as JServeConfig
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init

from apex_tpu_torch import monitor
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.monitor import events as pev
from apex_tpu_torch.monitor import meter as pmeter
from apex_tpu_torch.monitor import registry as preg
from apex_tpu_torch.monitor import sink as psink
from apex_tpu_torch.monitor import slo as pslo
from apex_tpu_torch.monitor.hist import Histogram
from apex_tpu_torch.serve import InferenceEngine, Request, ServeConfig
from apex_tpu_torch.transformer.testing import GPTConfig

JCFG = JGPTConfig(vocab_size=256, max_seq=128, hidden=128, num_layers=2,
                  num_heads=4, dtype=jnp.float32, fused_loss=False)
CFG = GPTConfig(vocab_size=256, max_seq=128, hidden=128, num_layers=2,
                num_heads=4, dtype=torch.float32)
JPARAMS = jax_init(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), "cpu")


def _clock(step=0.25):
    """A fake monotonic clock (seconds), advancing ``step`` per read."""
    c = itertools.count()
    return lambda: next(c) * step


# ---------------------------------------------------------------------------
# the monitor modules, module by module


def _drive_events(mod, seed=0):
    """A seeded lifecycle stream (two slots, bound fields, gauges, a shed
    and a decode chunk) through one package's EventLog."""
    rng = np.random.default_rng(seed)
    log = mod.EventLog(keep=True, clock=_clock())
    for i in range(4):
        uid = f"r{i}"
        log.bind(uid, trace=f"t{i}", tenant="a" if i % 2 else "b")
        log.emit("submitted", uid, prompt_tokens=int(rng.integers(1, 50)))
        log.gauge("queue_depth", i + 1)
    for i in range(3):
        uid, slot = f"r{i}", i % 2
        log.emit("admitted", uid, slot=slot, queue_ms=float(i))
        log.emit("prefill_start", uid, slot=slot)
        log.emit("prefill_end", uid, slot=slot)
        log.emit("first_token", uid, slot=slot, ttft_ms=1.5 * i)
        t0 = log.now_ms()
        log.emit("decode_chunk", uid, slot=slot, start_ms=round(t0, 3),
                 n_tokens=int(rng.integers(1, 16)))
        log.emit("retired", uid, slot=slot, n_tokens=7)
        log.gauge("occupancy", rng.random())
        log.unbind(uid)
    log.emit("shed", "r3", reason="unknown_adapter", adapter="x")
    return log.records


def test_event_log_and_traces_match_jax(tmp_path):
    """Records, request spans, stitched traces and the Chrome trace equal
    JAX's for the same stream on the same fake clock; the written trace
    file reads back as the same object."""
    want, got = _drive_events(jev), _drive_events(pev)
    assert got == want
    assert pev.request_spans(got) == jev.request_spans(want)
    assert pev.stitch_traces(got) == jev.stitch_traces(want)
    assert pev.chrome_trace(got) == jev.chrome_trace(want)
    assert pev.dedupe_events(got + got) == jev.dedupe_events(want + want)
    pev.write_chrome_trace(str(tmp_path / "p.json"), got)
    jev.write_chrome_trace(str(tmp_path / "j.json"), want)
    assert ((tmp_path / "p.json").read_text()
            == (tmp_path / "j.json").read_text())


def test_slo_tracker_report_matches_jax():
    """SloTracker over a seeded stream of retirements (some over budget,
    some with missing dimensions), on one fake clock a side: the same
    report, the same shared-histogram quantiles."""
    rng = np.random.default_rng(1)
    spec = dict(ttft_ms=50.0, tpot_ms=8.0, e2e_ms=400.0)
    j = jslo.SloTracker(jslo.SloSpec(**spec), window_s=3.0, clock=_clock())
    p = pslo.SloTracker(pslo.SloSpec(**spec), window_s=3.0, clock=_clock())
    for _ in range(40):
        m = dict(ttft_ms=float(rng.gamma(2.0, 20.0)),
                 tpot_ms=(float(rng.gamma(3.0, 2.5)) if rng.random() > 0.2
                          else None),
                 queue_ms=float(rng.random() * 10),
                 e2e_ms=float(rng.gamma(4.0, 80.0)))
        assert p.observe(**m) == j.observe(**m)
    assert p.report() == j.report()
    assert p.report(quantiles=(0.9,)) == j.report(quantiles=(0.9,))


def test_meter_ledgers_match_jax():
    """Meter charges (tenants past the cardinality bound, workers, every
    resource) give JAX's ledgers, rollups, worker rates and registry
    series."""
    rng = np.random.default_rng(2)
    model = dict(flops=2e-12, kv_block_s=0.03, adapter_s=0.5)
    j = jmeter.Meter(jmeter.CostModel(model), max_tenants=3)
    p = pmeter.Meter(pmeter.CostModel(model), max_tenants=3)
    for i in range(30):
        kw = dict(worker=f"w{i % 2}", t_ms=float(10 * i),
                  tokens=int(rng.integers(1, 40)), requests=1,
                  flops=float(rng.random() * 1e9),
                  kv_block_s=float(rng.random()),
                  adapter_s=float(rng.random()) if i % 3 else 0.0)
        tenant = f"t{int(rng.integers(0, 5))}"
        assert p.charge(tenant, **kw) == j.charge(tenant, **kw)
    assert p.stats(completed=32) == j.stats(completed=32)
    assert p.worker_rates(400.0) == j.worker_rates(400.0)
    assert (pmeter.modeled_request_flops(124_000_000, 12, 768, 300, 32, 64)
            == jmeter.modeled_request_flops(124_000_000, 12, 768, 300, 32,
                                            64))
    jr, pr = jreg.MetricsRegistry(), preg.MetricsRegistry()
    j.collect_registry(jr, t_ms=5.0)
    p.collect_registry(pr, t_ms=5.0)
    assert pr.expose_text() == jr.expose_text()


def _sink_records(rng, n):
    return [dict(step=i, metrics={"loss": float(rng.random()),
                                  "grad_norm": float(rng.random())},
                 phase="decode", tokens=int(rng.integers(0, 100)))
            for i in range(n)]


def _drop_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def test_jsonl_sink_rotation_and_read_back_match_jax(tmp_path):
    """The same records through both sinks with size rotation and a
    crash-truncated tail: the same segment names, the same records read
    back (timestamps aside), the same provenance-free json lines."""
    recs = _sink_records(np.random.default_rng(3), 60)
    paths = {}
    for name, mod in (("jax", jsink), ("port", psink)):
        d = tmp_path / name
        path = str(d / "m.jsonl")
        s = mod.JsonlSink(path, buffer_steps=4, rotate_bytes=1500)
        for r in recs:
            s.write(**r)
        s.write_many([{"kind": "event", "event": "x", "i": i}
                      for i in range(3)])
        s.close()
        with open(path, "a") as f:  # a writer that died mid-line
            f.write('{"schema": 1, "step": 9')
        paths[name] = path
    segs = {k: [os.path.basename(s) for s in mod.rotated_segments(p)]
            for (k, p), mod in zip(paths.items(), (jsink, psink))}
    assert segs["port"] == segs["jax"] and len(segs["jax"]) > 2
    want = _drop_ts(jsink.read_jsonl(paths["jax"]))
    got = _drop_ts(psink.read_jsonl(paths["port"]))
    assert got == want and len(got) == 63
    assert psink.json_record(a=1, b=[2]) == jsink.json_record(a=1, b=[2])
    psink.set_provenance({"run": "x"})
    try:
        assert '"provenance": {"run": "x"}' in psink.json_record(a=1)
    finally:
        psink.set_provenance(None)
    prov = psink.collect_provenance({"extra": 1})
    assert prov["torch_version"] == torch.__version__ and prov["extra"] == 1


def _fill_registry(mod, hist_cls, rng, worker, max_series=64):
    reg = mod.MetricsRegistry(max_series=max_series)
    for t in range(6):
        reg.counter("requests_total", float(rng.integers(1, 5)),
                    worker=worker, tenant=f"t{t % 3}")
    reg.gauge("occupancy", float(rng.random()), t_ms=float(rng.integers(
        0, 100)), worker=worker)
    reg.observe("ttft_ms", rng.gamma(2.0, 30.0, 50).tolist(), worker=worker)
    reg.set_histogram("e2e_ms", hist_cls().add(
        rng.gamma(3.0, 90.0, 40).tolist()), worker=worker)
    for i in range(10):  # past the bound: the overflow series
        reg.counter("hot_total", 1.0, key=f"k{i}")
    return reg


def test_metrics_registry_text_and_merge_match_jax():
    """Prometheus text, snapshots (cardinality overflow included) and the
    merged fleet view of two workers equal JAX's."""
    snaps = {}
    for name, mod, hist_cls in (("jax", jreg, JHistogram),
                                ("port", preg, Histogram)):
        rng = np.random.default_rng(4)
        regs = [_fill_registry(mod, hist_cls, rng, f"w{i}", max_series=12)
                for i in range(2)]
        snaps[name] = [r.snapshot(t_ms=50.0 + i)
                       for i, r in enumerate(regs)]
        if name == "jax":
            want_text = [r.expose_text() for r in regs]
        else:
            assert [r.expose_text() for r in regs] == want_text
    assert snaps["port"] == snaps["jax"]
    jv = jreg.merge_snapshots([("w0", snaps["jax"][0]),
                               ("w1", snaps["jax"][1])])
    pv = preg.merge_snapshots([("w0", snaps["port"][0]),
                               ("w1", snaps["port"][1])])
    assert pv.as_dict() == jv.as_dict()
    assert pv.total("requests_total") == jv.total("requests_total")
    assert (pv.hist("ttft_ms", worker="w1").to_dict()
            == jv.hist("ttft_ms", worker="w1").to_dict())


def test_fleet_scraper_coverage_matches_jax():
    """A scraper over two live targets and one that raises: the same view,
    misses and coverage on both sides."""
    views = {}
    for name, mod in (("jax", jreg), ("port", preg)):
        def dead():
            raise RuntimeError("down")

        def live(w):
            r = mod.MetricsRegistry()
            r.counter("tokens_total", 3.0, worker=w)
            return lambda: r.snapshot(1.0)

        sc = mod.FleetScraper(lambda: [("a", live("a")), ("b", live("b")),
                                       ("c", dead)], clock=_clock(0.001))
        v = sc.scrape(t_ms=2.0)
        views[name] = (v.as_dict(), sorted(v.missed),
                       sc.stats()["scrape_coverage"])
    assert views["port"] == views["jax"]


def test_metrics_record_and_norms_match_jax():
    """Metrics: sorted names, fp32 values, record / accumulate / merge;
    global_norm and train_metrics over the same trees as JAX's (fp32,
    rtol 1e-6)."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    jm = jmetrics.train_metrics(loss=jnp.float32(2.5), grads=tree,
                                params=tree).accumulate(steps=1, steps2=True)
    pm = monitor.train_metrics(loss=torch.tensor(2.5), grads=ttree,
                               params=ttree).accumulate(steps=1, steps2=True)
    assert pm.names() == jm.names()
    want, got = jm.as_dict(), pm.as_dict()
    assert list(got) == list(want)
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-6), k
    pm2 = pm.record(z=3).merge(monitor.Metrics({"a": 1}))
    assert pm2.names() == ("a", "grad_norm", "loss", "param_norm", "steps",
                           "steps2", "z")
    assert pm2.accumulate(z=2)["z"].item() == 5.0
    with pytest.raises(ValueError, match="scalars"):
        monitor.Metrics({"x": torch.ones(2)})
    assert monitor.global_norm({}).item() == 0.0


def test_span_records_in_the_torch_profiler():
    """A span is a torch-profiler range while a profiler records (and a
    no-op range outside one); span_function and step_annotation mark the
    same way."""
    @monitor.span_function(name="opt")
    def f(x):
        return x + 1

    with torch.profiler.profile() as prof:
        with monitor.span("decode"):
            f(torch.ones(4))
        with monitor.step_annotation(3):
            torch.ones(2).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"decode", "opt", "train_step#3"} <= keys
    with monitor.span("prefill"):
        pass
    assert set(monitor.PHASES) >= {"prefill", "decode", "verify"}


# ---------------------------------------------------------------------------
# the engines with telemetry on, JAX's and the port's


def _workload(seed=5):
    """Mixed prompt lengths; later requests share a 16-token prefix (two
    full blocks at block_size 8), one is exactly that prefix (a full hit:
    copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 16).tolist()
    prompts = [prefix + rng.integers(0, 256, 5).tolist(),
               rng.integers(0, 256, 3).tolist(),
               rng.integers(0, 256, 30).tolist(),
               prefix + rng.integers(0, 256, 9).tolist(),
               list(prefix),
               prefix + rng.integers(0, 256, 1).tolist(),
               rng.integers(0, 256, 17).tolist()]
    return [(f"r{i}", p, 6 + i % 3) for i, p in enumerate(prompts)]


# JAX's names for the per-op kernels vs the port's
_KERNEL_NAMES = {"reference": "plain", "pallas": "cuda", "fused": "fused"}
# stats() fields that are times (or rates over time), compared by presence
_TIME_KEYS = ("tokens_per_s",)


def _is_time_key(k):
    return (k in _TIME_KEYS or k.endswith("_ms_p50") or k.endswith("_ms_p99")
            or k.endswith("_component_ms_p50")
            or k.endswith("_component_ms_p99"))


def _comparable_stats(st, jax_side):
    out = {}
    for k, v in st.items():
        if k == "device" or _is_time_key(k):
            continue
        if k == "hists":
            v = {name: (h["spec"], h["count"]) for name, h in v.items()}
        if k in ("decode_kernel", "verify_kernel") and jax_side:
            v = _KERNEL_NAMES.get(v, v)
        out[k] = v
    return out


def _engines(spec_k, telemetry=False, tmp_path=None, **kw):
    """JAX's engine and the port's, the same ServeConfig, each with its own
    package's telemetry when asked (a sink under tmp_path, an EventLog
    keeping records, a meter)."""
    scfg = dict(num_slots=2, block_size=8, prefill_chunk=8, spec_k=spec_k,
                **kw)
    tel = {}
    for name, mod_sink, mod_ev, mod_meter, ctor in (
            ("jax", jsink, jev, jmeter,
             lambda **a: JEngine(JPARAMS, JCFG, JServeConfig(**scfg), **a)),
            ("port", psink, pev, pmeter,
             lambda **a: InferenceEngine(PARAMS, CFG, ServeConfig(**scfg),
                                         device="cpu", **a))):
        args = {}
        if telemetry:
            args = dict(sink=mod_sink.JsonlSink(
                str(tmp_path / f"{name}.jsonl"), buffer_steps=1),
                events=mod_ev.EventLog(keep=True), meter=mod_meter.Meter(),
                chunk_tokens=3, peak_flops_per_s=1e12)
        tel[name] = (ctor(**args), args)
    return tel


def _requests(mod_request, work, tenants=True):
    return [mod_request(u, p, max_new_tokens=m,
                        **({"tenant": f"t{i % 2}"} if tenants else {}))
            for i, (u, p, m) in enumerate(work)]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_stats_match_jax(spec_k):
    """stats() of the port equals JAX's on the same requests, key for key
    (the port adds ``device``), on every value that is not a time: counts,
    the prefix cache (hits, copy-on-write, prefill_flops_saved), the flat
    aliases, the roundings, the speculative counters and the histogram
    totals. The prefix workload has hits; spec_k=3 has verify steps."""
    work = _workload()
    eng = _engines(spec_k)
    jeng, peng = eng["jax"][0], eng["port"][0]
    assert (peng.run(_requests(Request, work, tenants=False))
            == jeng.run(_requests(JRequest, work, tenants=False)))
    jst, pst = jeng.stats(), peng.stats()
    assert set(pst) - set(jst) == {"device"}
    assert _comparable_stats(pst, False) == _comparable_stats(jst, True)
    assert pst["prefix_cache"]["blocks_hit"] > 0
    assert pst["prefix_cache"]["prefill_flops_saved"] > 0
    assert pst["prefix_hit_rate"] == round(pst["prefix_hit_rate"], 4)
    if spec_k:
        assert pst["speculative"]["verify_steps"] > 0
        assert pst["spec_acceptance_rate"] is not None
    for k in jst:
        if _is_time_key(k) and jst[k] is not None:
            assert isinstance(pst[k], float) and pst[k] > 0, k


def _event_key(r):
    if r["kind"] == "gauge":
        return ("gauge", r["gauge"], r["value"])
    return tuple(r.get(f) for f in ("event", "uid", "slot", "n_tokens",
                                    "reason"))


# sink fields that are times (or derived from one)
_SINK_TIME = ("ts", "step_ms", "tokens_per_s", "decode_mfu")


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_telemetry_matches_jax(spec_k, tmp_path):
    """Every telemetry piece on, both engines, the same requests: equal
    streams; equal event sequences (event, uid, slot, n_tokens, reason;
    gauges by value) in lifecycle order; sink records equal on every field
    that is not a time (one per step); equal registry counters; meter
    ledgers equal on tokens, requests and modeled flops."""
    work = _workload()
    eng = _engines(spec_k, telemetry=True, tmp_path=tmp_path)
    (jeng, jargs), (peng, pargs) = eng["jax"], eng["port"]
    assert (peng.run(_requests(Request, work))
            == jeng.run(_requests(JRequest, work)))
    jargs["sink"].close()
    pargs["sink"].close()
    jrec, prec = jargs["events"].records, pargs["events"].records
    assert [_event_key(r) for r in prec] == [_event_key(r) for r in jrec]
    assert any(r.get("event") == "decode_chunk" for r in prec)
    assert (pev.request_spans(prec).keys()
            == jev.request_spans(jrec).keys())
    for uid, spans in pev.request_spans(prec).items():
        names = [s["name"] for s in spans if s["name"] != "decode_chunk"]
        assert names == ["queued", "prefill", "decode"], uid
    js = list(jsink.read_jsonl(str(tmp_path / "jax.jsonl")))
    ps = list(psink.read_jsonl(str(tmp_path / "port.jsonl")))
    assert len(ps) == len(js) == peng.stats()["steps"]

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in _SINK_TIME}
                for r in recs]

    assert strip(ps) == strip(js)
    assert all("decode_mfu" in r for r in ps if r["phase"] == "decode")

    def counters(e, mod):
        reg = mod.MetricsRegistry()
        e.collect_registry(reg, worker="w0", t_ms=1.0, include_hists=True)
        snap = reg.snapshot(1.0)
        return {s["name"]: s["value"] for s in snap["series"]
                if s["kind"] == "counter"}

    assert counters(peng, preg) == counters(jeng, jreg)
    assert peng.scrape(t_ms=1.0)["series"][0]["name"] == "worker_up"
    jm, pm = jeng.stats()["meter"], peng.stats()["meter"]
    for t in jm["tenants"]:
        for f in ("flops", "tokens", "requests"):
            assert pm["tenants"][t][f] == jm["tenants"][t][f], (t, f)
    assert pm["totals"]["tokens"] == peng.stats()["generated_tokens"]


def _evict_restore_run(engine_cls, request_cls, work, victims):
    """Step the engine, evict the victims once each has decoded a few
    tokens, step twice more, restore them, and finish."""
    eng = engine_cls()
    for r in _requests(request_cls, work):
        eng.submit(r)
    evicted, done = {}, set()
    while eng.active or evicted:
        eng.step()
        for uid in victims:
            if uid in done or uid in evicted:
                continue
            slot = next((i for i, s in enumerate(eng._slots)
                         if s is not None and s.request.uid == uid), None)
            if slot is not None and len(eng._slots[slot].generated) >= 3 \
                    and eng._active[slot]:
                evicted[uid] = [eng.evict_slot(uid), 2]
        for uid in list(evicted):
            evicted[uid][1] -= 1
            if evicted[uid][1] < 0 and eng._free_slot() is not None:
                eng.restore_slot(evicted.pop(uid)[0])
                done.add(uid)
    assert done == set(victims)
    return eng.finished


@pytest.mark.parametrize("spec_k", [0, 3])
def test_evict_restore_is_bitwise_a_no_op(spec_k):
    """A decoding request evicted mid-stream and restored later gives the
    stream of the uninterrupted run, on both packages, and the two agree;
    a mid-prefill slot refuses eviction."""
    work = _workload()
    scfg = dict(num_slots=2, block_size=8, prefill_chunk=8, spec_k=spec_k)
    ref = InferenceEngine(PARAMS, CFG, ServeConfig(**scfg),
                          device="cpu").run(_requests(Request, work))
    victims = ["r0", "r3"]
    got = _evict_restore_run(
        lambda: InferenceEngine(PARAMS, CFG, ServeConfig(**scfg),
                                device="cpu"), Request, work, victims)
    want = _evict_restore_run(
        lambda: JEngine(JPARAMS, JCFG, JServeConfig(**scfg)), JRequest,
        work, victims)
    assert got == ref
    assert want == got
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(**scfg), device="cpu")
    eng.submit(Request("long", list(range(30)), max_new_tokens=4))
    eng.step()
    with pytest.raises(RuntimeError, match="mid-prefill"):
        eng.evict_slot("long")
    with pytest.raises(KeyError):
        eng.evict_slot("nobody")


def test_engine_slo_and_hists_share_one_fold():
    """With an SloSpec, the tracker folds into the engine's own
    histograms: one observation per retired request, the report's
    quantiles are stats()'s, and attribution covers every request."""
    work = _workload()
    eng = InferenceEngine(PARAMS, CFG, ServeConfig(
        num_slots=2, block_size=8, prefill_chunk=8), device="cpu",
        slo=monitor.SloSpec(ttft_ms=1e9, e2e_ms=1e9))
    eng.run(_requests(Request, work))
    st = eng.stats()
    rep = st["slo_report"]
    assert rep["completed"] == rep["good"] == len(work)
    assert st["hists"]["ttft_ms"]["count"] == len(work)
    assert rep["ttft_ms_p50"] == st["ttft_ms_p50"]
    assert st["attrib_coverage"] == 1.0
    for c in ("queue", "prefill", "decode"):
        assert f"{c}_component_ms_p50" in st


def test_engine_telemetry_off_adds_nothing():
    """With every telemetry argument None the engine keeps no event, sink
    or meter state, and its streams and host-to-device uploads equal an
    engine's with telemetry on (the telemetry reads host state only)."""
    work = _workload()
    scfg = ServeConfig(num_slots=2, block_size=8, prefill_chunk=8, spec_k=3)
    off = InferenceEngine(PARAMS, CFG, scfg, device="cpu")
    out = off.run(_requests(Request, work))
    on = InferenceEngine(PARAMS, CFG, scfg, device="cpu",
                         events=monitor.EventLog(keep=True),
                         meter=monitor.Meter(),
                         slo=monitor.SloSpec(ttft_ms=1e9),
                         sink=_ListSink())
    assert on.run(_requests(Request, work)) == out
    assert on.transfer_counts == off.transfer_counts
    assert off.transfer_counts["adapter_ids"] == 0
    st = off.stats()
    assert "meter" not in st and "slo_report" not in st
    assert off._events is None and off._sink is None


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, **fields):
        self.records.append(fields)
