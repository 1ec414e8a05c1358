"""Where the host time of the PyTorch port's ``GanEngine`` goes, on one
CUDA card.

    python3 tools/gan_engine_probe.py [--seconds S] [--out FILE]

Full-width DCGAN (random weights from seed 0, f32, TF32 off).  Every
result is printed as a line ``PROBE {json}`` that also carries the
card's name and power limit (``nvidia-smi``).

``launch``
    Host ms to issue one batch of 64 (median of 100 batches: 10 rounds,
    in each of which every variant takes 10 batches after 2 warm-up
    ones in turn, so that the host's drift reaches every variant alike;
    the least and most of the per-round medians are printed too; the
    card is synchronised between batches, outside the timed span), in
    steps that add one piece of the engine's
    ``_dispatch`` at a time: ``Program.apply`` on the main thread, the
    same on a worker thread, the whole dispatch (latents, the compute
    stream, the pinned staging buffer, the copy on the copy stream) on a
    worker thread, then the dispatch followed by the wait for its copy,
    by the engine's whole answer (the wait, then the rows copied out of
    pinned memory into fresh host memory), or by a host copy of as many
    bytes that involves no card, and the dispatch with the answer on a
    second thread; each with the default intra-op CPU threads and with
    one; last, dispatch and answer beside a Python thread that spins
    (GIL contention; 10 batches).
``sustained``
    The engine under S seconds (default 8, in 4 rounds taken in turn
    with the other configurations) of closed-loop traffic: 4
    producer threads, each submitting requests of 1–100 images (drawn
    from the producer's own seed) and waiting for each answer before
    the next.  Images/s over the window (and the least and most of the
    rounds'), each request's submit-to-answer p50/p99,
    batches, and the medians of the scheduler's host ms a batch in
    ``_dispatch``, in ``Program.apply`` inside it, and in ``_resolve``;
    at ``pipeline_depth`` 1 and 2, and at depth 1 with one intra-op CPU
    thread.  Beside them the synchronous ``GanServer.generate(n)`` over
    the same request sizes from one thread, with and without the copy
    of each answer to the host.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64
PRODUCERS = 4
WAIT_S = 60.0
# the variants and configurations take turns, this many rounds each
LAUNCH_ROUNDS = 10
SUSTAINED_ROUNDS = 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def emit(card: str, **row) -> dict:
    row["card"] = card
    print("PROBE " + json.dumps(row), flush=True)
    return row


def host_times(body, runs: int = 10, warmup: int = 2) -> dict:
    """Host ms of ``body(mark)`` a call (key ``ms``), which may book the
    ms of its own pieces into ``mark`` (a dict of lists); the card is
    synchronised before each call, outside the timed span."""
    import torch
    out: dict[str, list[float]] = {"ms": []}
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        mark: dict[str, list[float]] = {}
        t0 = time.perf_counter()
        body(mark)
        dt = (time.perf_counter() - t0) * 1e3
        if i >= warmup:
            out["ms"].append(dt)
            for k, v in mark.items():
                out.setdefault(f"{k}_ms", []).extend(v)
    torch.cuda.synchronize()
    return out


def summary(samples: dict, rounds: list[float]) -> dict:
    """The median of every list of samples, and the least and most of
    the per-round medians of the total (the host's drift)."""
    return {**{k: statistics.median(v) for k, v in samples.items()},
            "round_medians_min": min(rounds),
            "round_medians_max": max(rounds)}


def on_worker(fn):
    """``fn()`` on a new thread, the caller blocked in ``join``."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def launch_costs(card, dev, cfg, g) -> list[dict]:
    import torch
    from repro_torch.program import Program
    prog = Program.build(cfg, BATCH, device=dev, differentiable=False)
    z = torch.randn((BATCH, cfg.z_dim), device=dev)
    key = torch.Generator(device=dev).manual_seed(0)
    compute, copy = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def apply(mark):
        prog.apply(g, z)

    def tick(mark, name, t0):
        t1 = time.perf_counter()
        mark.setdefault(name, []).append((t1 - t0) * 1e3)
        return t1

    def dispatch(mark):
        """The engine's ``_dispatch``, piece by piece."""
        with torch.cuda.stream(compute), torch.inference_mode():
            t = time.perf_counter()
            lat = torch.randn((BATCH, cfg.z_dim), generator=key, device=dev)
            t = tick(mark, "latents", t)
            out = prog.apply(g, lat)
            t = tick(mark, "apply", t)
            computed = torch.cuda.Event()
            computed.record(compute)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            t = tick(mark, "pinned_alloc", t)
            with torch.cuda.stream(copy):
                copy.wait_event(computed)
                host.copy_(out, non_blocking=True)
                out.record_stream(copy)
                ready = torch.cuda.Event()
                ready.record(copy)
            tick(mark, "copy_enqueue", t)
        return host, ready

    def dispatch_and_answer(mark):
        """``_dispatch``, then ``_resolve``'s wait and copy-out."""
        host, ready = dispatch(mark)
        t = time.perf_counter()
        ready.synchronize()
        t = tick(mark, "copy_wait", t)
        torch.empty(host.shape, dtype=host.dtype).copy_(host)
        tick(mark, "copy_out", t)

    def dispatch_and_wait(mark):
        """``_dispatch``, then the wait for the copy, no copy-out."""
        host, ready = dispatch(mark)
        t = time.perf_counter()
        ready.synchronize()
        tick(mark, "copy_wait", t)

    src = torch.empty((BATCH, 64, 64, 3))
    dst = torch.empty_like(src)

    def dispatch_and_host_copy(mark):
        """``_dispatch``, then a host copy of as many bytes that touches
        no pinned memory and waits for nothing on the card."""
        dispatch(mark)
        t = time.perf_counter()
        dst.copy_(src)
        tick(mark, "host_copy", t)

    answers = []     # (host, ready) handed from the dispatcher
    answered = threading.Condition()
    stop = [False]

    def answerer():
        while True:
            with answered:
                while not answers and not stop[0]:
                    answered.wait()
                if not answers:
                    return
                host, ready = answers.pop(0)
            ready.synchronize()
            torch.empty(host.shape, dtype=host.dtype).copy_(host)

    def dispatch_answered_elsewhere(mark):
        """``_dispatch`` on this thread; the wait and the copy-out on
        another (the previous batch's run while this one issues)."""
        out = dispatch(mark)
        with answered:
            answers.append(out)
            answered.notify()

    spin_stop = threading.Event()

    def spin():
        n = 0
        while not spin_stop.is_set():
            n += 1

    def answered_elsewhere():
        stop[0] = False
        helper = threading.Thread(target=answerer)
        helper.start()
        try:
            return host_times(dispatch_answered_elsewhere)
        finally:
            with answered:
                stop[0] = True
                answered.notify()
            helper.join()

    threads = torch.get_num_threads()
    variants = []
    for n_threads in (threads, 1):
        for name, body in (
                ("apply, main thread", apply),
                ("apply, worker thread", apply),
                ("dispatch, worker thread", dispatch),
                ("dispatch + wait for the copy, worker thread",
                 dispatch_and_wait),
                ("dispatch + answer, worker thread", dispatch_and_answer),
                ("dispatch + a host copy of 3.1 MB, worker thread",
                 dispatch_and_host_copy)):
            if name.endswith("main thread"):
                run = (lambda body=body: host_times(body))
            else:
                run = (lambda body=body: on_worker(
                    lambda: host_times(body)))
            variants.append((name, n_threads, run))
        variants.append(("dispatch on a worker thread, answer on another",
                         n_threads, lambda: on_worker(answered_elsewhere)))
    # the host drifts: every variant takes 10 batches a round, in turn
    samples = {i: {} for i in range(len(variants))}
    rounds = {i: [] for i in range(len(variants))}
    for _ in range(LAUNCH_ROUNDS):
        for i, (_, n_threads, run) in enumerate(variants):
            torch.set_num_threads(n_threads)
            got = run()
            rounds[i].append(statistics.median(got["ms"]))
            for k, v in got.items():
                samples[i].setdefault(k, []).extend(v)
    torch.set_num_threads(threads)
    rows = [emit(card, part="launch", variant=name,
                 intra_op_threads=n_threads, batches=len(samples[i]["ms"]),
                 **summary(samples[i], rounds[i]))
            for i, (name, n_threads, _) in enumerate(variants)]
    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        # each op waits out the interpreter's switch interval: few batches
        got = on_worker(lambda: host_times(dispatch_and_answer))
        rows.append(emit(card, part="launch",
                         variant="dispatch + answer, worker thread, a "
                                 "spinning Python thread beside it",
                         intra_op_threads=threads, batches=len(got["ms"]),
                         **summary(got, [statistics.median(got["ms"])])))
    finally:
        spin_stop.set()
        spinner.join()
    return rows


def request_sizes(producer: int):
    import torch
    gen = torch.Generator().manual_seed(producer)
    while True:
        yield from torch.randint(1, 101, (64,), generator=gen).tolist()


def time_engine(engine) -> dict:
    """Book the scheduler's host ms per batch in ``_dispatch``,
    ``_resolve`` and the program's ``apply``."""
    spent = {"_dispatch": [], "_resolve": [], "apply": []}
    for name, owner in (("_dispatch", engine), ("_resolve", engine),
                        ("apply", engine.program)):
        def timed(*a, real=getattr(owner, name), times=spent[name]):
            t0 = time.perf_counter()
            out = real(*a)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(owner, name, timed)
    return spent


def drive(engine, seconds: float, latencies: list, spent: dict) -> int:
    """Closed-loop traffic through ``engine`` for ``seconds``: PRODUCERS
    threads, each waiting for its answer before its next request.
    Returns the images served; books each request's latency."""
    served, errors = [0] * PRODUCERS, []
    deadline = time.perf_counter() + seconds

    def produce(p):
        try:
            for n in request_sizes(p):
                if time.perf_counter() >= deadline:
                    return
                fut = engine.submit(n)
                fut.result(WAIT_S)
                served[p] += n
                latencies.append(fut.latency_us)
        except Exception as e:      # surfaced below
            errors.append(e)
    producers = [threading.Thread(target=produce, args=(p,))
                 for p in range(PRODUCERS)]
    for t in producers:
        t.start()
    for t in producers:
        t.join(seconds + WAIT_S)
    engine.close(timeout=WAIT_S)
    if errors or any(t.is_alive() for t in producers):
        raise SystemExit(f"gan_engine_probe: producers failed: {errors}")
    return sum(served)


def sustained(card, dev, cfg, g, seconds: float) -> list[dict]:
    import torch
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    threads = torch.get_num_threads()
    configs = [("GanEngine", 1, threads), ("GanEngine", 2, threads),
               ("GanEngine", 1, 1), ("GanServer.generate", None, threads),
               ("GanServer.generate, answers copied to the host", None,
                threads)]
    totals = [{"images": 0, "wall_s": 0.0, "batches": 0, "latencies": [],
               "spent": {"_dispatch": [], "_resolve": [], "apply": []},
               "rounds": []} for _ in configs]
    servers = {i: GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
               for i, c in enumerate(configs) if c[1] is None}
    chunk = seconds / SUSTAINED_ROUNDS
    # the host drifts: every configuration takes a chunk a round, in turn
    for _ in range(SUSTAINED_ROUNDS):
        for i, (what, depth, n_threads) in enumerate(configs):
            torch.set_num_threads(n_threads)
            tot = totals[i]
            if depth is not None:
                engine = GanEngine(cfg, g, buckets=(8, 16, 32, 64), seed=0,
                                   pipeline_depth=depth, device=dev)
                spent = time_engine(engine)
                t0 = time.perf_counter()
                images = drive(engine, chunk, tot["latencies"], spent)
                wall = time.perf_counter() - t0
                tot["batches"] += engine.batches_served
                for k, v in spent.items():
                    tot["spent"][k] += v
            else:
                server, to_host = servers[i], "host" in what
                sizes, images = request_sizes(0), 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < chunk:
                    n = next(sizes)
                    out = server.generate(n)
                    if to_host:
                        out = out.cpu()
                    images += n
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            tot["images"] += images
            tot["wall_s"] += wall
            tot["rounds"].append(images / wall)
    torch.set_num_threads(threads)
    rows = []
    for (what, depth, n_threads), tot in zip(configs, totals):
        row = {"part": "sustained", "what": what,
               "intra_op_threads": n_threads, "wall_s": tot["wall_s"],
               "images": tot["images"],
               "images_per_s": tot["images"] / tot["wall_s"],
               "round_images_per_s_min": min(tot["rounds"]),
               "round_images_per_s_max": max(tot["rounds"])}
        if depth is not None:
            lat = sorted(tot["latencies"])
            row.update(
                pipeline_depth=depth, producers=PRODUCERS,
                requests=len(lat), batches=tot["batches"],
                request_p50_us=lat[len(lat) // 2],
                request_p99_us=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
                **{f"{k}_ms_median": statistics.median(v)
                   for k, v in tot["spent"].items()})
        rows.append(emit(card, **row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every row as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gan_engine_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.models.gan import GanConfig, init_gan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(("ganax_conv", "ganax_conv3d"))
    card = card_line()
    dev = torch.device("cuda", 0)
    cfg = GanConfig("dcgan")
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device=dev)
    rows = launch_costs(card, dev, cfg, g)
    rows += sustained(card, dev, cfg, g, args.seconds)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
