"""The PyTorch port's continuous-batching engine (``repro_torch.serve
.gan_engine``) and ``GanServer``'s async façade, on the CPU.

Mirrors ``tests/test_gan_engine.py``: bit-parity with the sequential
server under concurrent producers, the remainder invariant under
interleaving, clean shutdown with requests in flight, a scheduler
exception, backpressure, bucket choice, an exported program,
rejections, metrics and spans, and the façade's mixed sync/async
stream.  Where the reference's test pins a deterministic submission
schedule, the port's engine draws the same bucket sizes and gives the
same offsets as the reference's engine (images are not compared across
frameworks: the random streams differ).  Every wait has a timeout.
"""

import threading
import time

import jax
import pytest
import torch

from repro.models import gan as jgan
from repro.serve.gan_engine import GanEngine as JEngine
from repro_torch import obs
from repro_torch.models.gan import GanConfig, init_gan
from repro_torch.program import Program, ProgramSpec
from repro_torch.serve.gan import GanServer
from repro_torch.serve.gan_engine import GanEngine, ServerClosed

SCALE = 0.03125
WAIT = 30


def _cfg(**kw):
    return GanConfig("dcgan", channel_scale=SCALE, **kw)


@pytest.fixture(scope="module")
def g():
    params, _ = init_gan(_cfg(), torch.Generator().manual_seed(0), "cpu")
    return params


def _engine(g, buckets, seed=0, **kw):
    return GanEngine(_cfg(), g, buckets=buckets, seed=seed, device="cpu",
                     **kw)


def _server(g, batch_size=4, seed=0):
    return GanServer(_cfg(), g, batch_size=batch_size, seed=seed,
                     device="cpu")


def _close(eng, drain=True):
    eng.close(drain=drain, timeout=WAIT)
    assert not eng._thread.is_alive()


def _reassemble(futures):
    outs = [(f, f.result(WAIT)) for f in futures]
    outs.sort(key=lambda pair: pair[0].offset)
    return torch.cat([o for _, o in outs])


def _produce(eng, sizes):
    futures, lock = [], threading.Lock()

    def produce(n):
        f = eng.submit(n)
        with lock:
            futures.append(f)
    threads = [threading.Thread(target=produce, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    return futures


# -- bit-parity with the sequential server ----------------------------------

def test_sequential_parity_with_gan_server(g):
    ref = _server(g, seed=5).generate(8)
    eng = _engine(g, (4,), seed=5)
    chunked = torch.cat([eng.generate(3, WAIT), eng.generate(3, WAIT),
                         eng.generate(2, WAIT)])
    _close(eng)
    assert chunked.device.type == "cpu"
    torch.testing.assert_close(chunked, ref, rtol=0, atol=0)


@pytest.mark.parametrize("sizes", [(3, 3, 2), (1, 1, 1, 1, 4), (5, 2, 1)])
def test_concurrent_producers_bit_parity(g, sizes):
    ref = _server(g, seed=7).generate(sum(sizes))
    eng = _engine(g, (4,), seed=7)
    out = _reassemble(_produce(eng, sizes))
    _close(eng)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _schedule(make, sizes):
    """A sequential submission schedule: generated count and offset
    after each request, then the buffered count."""
    eng = make()
    trace = []
    for n in sizes:
        fut = eng.submit(n)
        fut.result(WAIT)
        trace.append((eng.samples_generated, fut.offset))
    out = trace + [eng.samples_buffered]
    eng.close(timeout=WAIT)
    return out


@pytest.mark.parametrize("buckets,sizes", [
    ((1, 2, 4), (3, 4)), ((1, 2, 4), (1, 2, 7)),
    ((1, 2, 4), (1, 2, 4, 3, 7, 4, 1, 2)), ((2, 8), (5, 9, 1, 3))])
def test_bucket_sizes_and_offsets_match_the_reference(g, buckets, sizes):
    jcfg = jgan.GanConfig("dcgan", channel_scale=SCALE)
    jg, _ = jgan.init_gan(jcfg, jax.random.PRNGKey(0))
    ref = _schedule(lambda: JEngine(jcfg, jg, buckets=buckets, seed=0),
                    sizes)
    got = _schedule(lambda: _engine(g, buckets), sizes)
    assert got == ref


def test_engine_deterministic_across_runs(g):
    outs = []
    for _ in range(2):
        eng = _engine(g, (1, 2, 4), seed=11)
        outs.append(torch.cat([eng.generate(3, WAIT), eng.generate(4, WAIT)]))
        _close(eng)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# -- remainder-buffer accounting under interleaving -------------------------

def test_remainder_invariant_under_interleaving(g):
    sizes = [3, 1, 5, 2, 7, 1, 4, 3]
    eng = _engine(g, (1, 2, 4))
    futures = _produce(eng, sizes)
    for f in futures:
        assert tuple(f.result(WAIT).shape) == (f.n, 64, 64, 3)
    assert eng.samples_served == sum(sizes)
    assert eng.samples_discarded == 0
    assert eng.samples_served + eng.samples_buffered + \
        eng.samples_discarded == eng.samples_generated + eng.initial_spare
    _close(eng)
    assert eng.samples_served + eng.samples_buffered + \
        eng.samples_discarded == eng.samples_generated


def test_spare_buffer_carries_across_requests(g):
    eng = _engine(g, (4,), seed=3)
    eng.generate(3, WAIT)
    assert (eng.samples_served, eng.samples_buffered) == (3, 1)
    assert eng.batches_served == 1
    eng.generate(1, WAIT)          # served from the buffer, no new batch
    assert (eng.samples_served, eng.samples_buffered) == (4, 0)
    assert eng.batches_served == 1
    _close(eng)


# -- clean shutdown ---------------------------------------------------------

def test_close_drains_requests_in_flight(g):
    eng = _engine(g, (2,))
    futures = [eng.submit(3) for _ in range(4)]
    _close(eng)                       # drain=True
    for f in futures:
        assert tuple(f.result(WAIT).shape) == (3, 64, 64, 3)
    assert eng.samples_served == 12


def _stall(eng, bucket, release):
    real_apply = eng.program.apply

    def slow_apply(params, z):
        if z.shape[0] == bucket:
            release.wait(10)
        return real_apply(params, z)
    eng.program.apply = slow_apply


def test_close_without_drain_fails_unscheduled_requests(g):
    release = threading.Event()
    eng = _engine(g, (2,))
    _stall(eng, 2, release)
    futures = [eng.submit(2) for _ in range(6)]
    time.sleep(0.05)                  # let the scheduler enter dispatch
    threading.Timer(0.05, release.set).start()
    _close(eng, drain=False)
    answered = failed = 0
    for f in futures:
        err = f.exception(WAIT)       # never hangs
        if err is None:
            assert tuple(f.result().shape) == (2, 64, 64, 3)
            answered += 1
        else:
            assert isinstance(err, ServerClosed)
            failed += 1
    assert answered + failed == 6 and failed >= 1
    with pytest.raises(ServerClosed):
        eng.submit(1)


def test_scheduler_exception_fails_outstanding_requests(g):
    eng = _engine(g, (2,))

    def boom(params, z):
        raise RuntimeError("device on fire")
    eng.program.apply = boom
    f = eng.submit(2)
    with pytest.raises(RuntimeError, match="device on fire"):
        f.result(WAIT)
    with pytest.raises(ServerClosed):
        eng.submit(1)
    _close(eng)


def test_context_manager_closes(g):
    eng = _engine(g, (2,))

    def use():
        with eng:
            eng.generate(2, WAIT)
    user = threading.Thread(target=use)
    user.start()
    user.join(WAIT)              # __exit__ closes: bounded all the same
    assert not user.is_alive() and not eng._thread.is_alive()
    with pytest.raises(ServerClosed):
        eng.submit(1)


def test_backpressure_bounds_the_queue(g):
    release = threading.Event()
    eng = _engine(g, (2,), max_pending=1)
    _stall(eng, 2, release)
    first = eng.submit(2)             # occupies the single queue slot
    time.sleep(0.05)
    with pytest.raises(TimeoutError):
        eng.submit(2, timeout=0.05)
    release.set()
    assert tuple(first.result(WAIT).shape) == (2, 64, 64, 3)
    _close(eng)


# -- ahead-of-time bucket set ----------------------------------------------

def test_bucket_set_shares_one_spec(g):
    eng = _engine(g, (1, 2, 4))
    sizes, real_apply = [], eng.program.apply

    def booked(params, z):
        sizes.append(z.shape[0])
        return real_apply(params, z)
    eng.program.apply = booked
    for n in (1, 2, 4, 3, 7, 4, 1, 2):
        eng.generate(n, WAIT)
    # one program, one spec, every bucket served through it
    assert eng.buckets == (1, 2, 4) and set(sizes) == {1, 2, 4}
    assert eng.program.spec is eng.spec and not eng.program.differentiable
    _close(eng)


def test_exported_program_drives_engine(g):
    ref_srv = _server(g, seed=9)
    spec = ProgramSpec.from_json(ref_srv.program.spec.to_json())
    eng = _engine(g, (4,), seed=9,
                  program=Program(spec, device="cpu", differentiable=False))
    got = eng.generate(6, WAIT)
    _close(eng)
    torch.testing.assert_close(got, ref_srv.generate(6), rtol=0, atol=0)


def test_engine_rejects_mismatched_program(g):
    disc = Program(ProgramSpec.build(_cfg(), 4, "discriminator"),
                   device="cpu")
    with pytest.raises(ValueError, match="generator"):
        _engine(g, (4,), program=disc)
    other = Program(ProgramSpec.build(
        GanConfig("dcgan", channel_scale=2 * SCALE), 4, "generator"),
        device="cpu")
    with pytest.raises(ValueError, match="different workload"):
        _engine(g, (4,), program=other)
    with pytest.raises(ValueError, match="different workload"):
        GanServer(_cfg(), g, batch_size=2, program=other, device="cpu")


def test_engine_rejects_bad_parameters(g):
    with pytest.raises(ValueError, match="buckets"):
        _engine(g, ())
    with pytest.raises(ValueError, match="buckets"):
        _engine(g, (0, 2))
    with pytest.raises(ValueError, match="pipeline_depth"):
        _engine(g, (2,), pipeline_depth=0)
    with pytest.raises(ValueError, match="max_pending"):
        _engine(g, (2,), max_pending=0)
    eng = _engine(g, (2,))
    with pytest.raises(ValueError, match="positive"):
        eng.submit(0)
    _close(eng)


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth_keeps_the_stream(g, depth):
    ref = _server(g, batch_size=2, seed=4).generate(12)
    eng = _engine(g, (2,), seed=4, pipeline_depth=depth)
    out = _reassemble(_produce(eng, (3, 5, 4)))
    _close(eng)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# -- observability ----------------------------------------------------------

def test_engine_metrics_and_request_spans(g):
    sink = obs.enable()
    try:
        eng = _engine(g, (4,))
        for n in (3, 5, 4):
            eng.generate(n, WAIT)
        labels = {"engine": eng.engine_id}
        h = obs.histogram("engine.request_us", **labels)
        assert h.count == 3 and h.percentile(50) > 0
        occ = obs.histogram("engine.batch_occupancy", **labels)
        assert occ.count == eng.batches_served
        assert obs.counter("engine.requests", **labels).value == 3
        assert obs.gauge("engine.queue_depth", **labels).value == 0
        _close(eng)
    finally:
        obs.disable()
    spans = sink.spans("engine.request")
    assert len(spans) == 3
    assert sorted(s["attrs"]["n"] for s in spans) == [3, 4, 5]
    assert all(s["dur_us"] > 0 for s in spans)
    offs = sorted((s["attrs"]["offset"], s["attrs"]["n"]) for s in spans)
    pos = 0
    for off, n in offs:
        assert off == pos
        pos += n
    applies = sink.spans("program.apply")
    assert len(applies) == eng.batches_served + 1      # + the warm-up
    assert len(sink.spans("program.layer")) == 4 * len(applies)


# -- GanServer async façade -------------------------------------------------

def test_server_facade_mixed_sync_async_parity(g):
    ref = _server(g, seed=5).generate(12)
    srv = _server(g, seed=5)
    parts = [srv.generate(3)]                 # sync path (buffers 1)
    parts.append(srv.submit(5).result(WAIT))  # façade takes over
    parts.append(srv.generate(4))             # delegated
    assert srv.samples_served == 12
    assert srv.batches_served == 3
    assert srv.samples_served + srv.samples_buffered + \
        srv.samples_discarded == srv.batches_served * 4
    assert all(p.device.type == "cpu" for p in parts)
    srv.close(timeout=WAIT)
    assert not srv._engine._thread.is_alive()
    torch.testing.assert_close(torch.cat(parts), ref, rtol=0, atol=0)


def test_server_close_without_submit_is_noop(g):
    srv = _server(g, batch_size=2)
    srv.close(timeout=WAIT)
    assert tuple(srv.generate(2).shape) == (2, 64, 64, 3)


def test_server_metrics_spans_and_describe(g):
    sink = obs.enable()
    try:
        srv = _server(g, batch_size=4)
        srv.generate(3)
        srv.generate(6)
    finally:
        obs.disable()
    labels = {"server": srv.server_id}
    snap = obs.snapshot()
    assert snap["counters"][f"serve.batches{{server={srv.server_id}}}"] \
        == srv.batches_served == 3
    assert obs.counter("serve.samples_served", **labels).value == 9
    assert obs.gauge("serve.samples_buffered", **labels).value == \
        srv.samples_buffered == 3
    assert obs.histogram("serve.request_us", **labels).count == 2
    assert obs.histogram("serve.batch_occupancy", **labels).count == 3
    gens = sink.spans("serve.generate")
    assert [s["attrs"]["batches"] for s in gens] == [1, 2]
    for apply in sink.spans("program.apply"):
        assert any(s["ts_us"] <= apply["ts_us"] and apply["ts_us"]
                   + apply["dur_us"] <= s["ts_us"] + s["dur_us"]
                   and apply["depth"] == s["depth"] + 1 for s in gens)
    text = srv.describe()
    assert text.count("-> ganax") == 4 and "program dcgan/generator" in text
    assert "policy=ganax" in repr(srv)


def test_many_producers_under_a_short_switch_interval(g):
    """More producer threads than cores, with the interpreter switching
    threads every microsecond: the stream reassembles exactly and the
    accounting invariant holds (a lost update would break either)."""
    import os
    import sys
    threads = min(128, 2 * (os.cpu_count() or 8))
    sizes = [1 + (7 * i) % 5 for i in range(threads)]
    ref = _server(g, batch_size=4, seed=13).generate(sum(sizes))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = _engine(g, (4,), seed=13, pipeline_depth=2)
        out = _reassemble(_produce(eng, sizes))
        _close(eng)
    finally:
        sys.setswitchinterval(old)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert eng.samples_served == sum(sizes)
    assert eng.samples_served + eng.samples_buffered + \
        eng.samples_discarded == eng.samples_generated
    assert obs.counter("engine.requests", engine=eng.engine_id).value == \
        len(sizes)
