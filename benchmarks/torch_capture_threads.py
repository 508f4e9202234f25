#!/usr/bin/env python3
"""Two engines capturing CUDA graphs on two threads at once, on one card.

The online server (``repro_torch.serving.online``) runs different pool
members on different worker threads, so one member's engine may capture a
CUDA graph while another member's engine launches, allocates or waits.
This script serves two full-width Qwen1.5-0.5B engines (bf16, paged, page
16, random weights) from two threads started together, each through serves
whose table widths change, so that every serve captures a new key, and
holds the streams and the paged kernel's launches against the same serves
run one engine after the other, in 3 rounds.  ``GraphSet`` captures on a
stream of its own in thread-local mode, each capture's launches in a tally
of its own thread; a capture through ``torch.cuda.graph`` (one capture
stream shared by every graph of the process, global mode, a device-wide
synchronisation on entry) failed here at its first capture beside the
other thread's serving, as ``PERF.md`` records.

    python3 benchmarks/torch_capture_threads.py

Prints one JSON line (the errors raised, whether the concurrent streams and
launches equal the sequential ones, captures and replays, and how many
captures overlapped the other thread's serving), then whether the captures
were safe; exits 0 only if they were.  Needs one card.
"""
import json
import sys
import threading
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_SERVES = 6          # serves a thread; each widens the page table
ROUNDS = 3
SLOTS = 8


def requests(seed, serve):
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1000 * seed + serve)
    length = 40 + 90 * serve
    return [Request(rid=i, tokens=rng.integers(3, 20000, size=length + i).tolist(),
                    max_new=24) for i in range(SLOTS)]


def rounds() -> dict:
    from repro_torch.config import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.transformer import Model
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import ServingEngine

    build.build_all(("flash_attention", "paged_attention"))
    dev = torch.device("cuda:0")
    models = [Model(get_arch("qwen1.5-0.5b"), device=dev).init(
        torch.Generator(device=dev).manual_seed(s)) for s in (0, 1)]
    spans = {0: [], 1: []}               # (start, end, kind) a thread
    real_capture = graphs.GraphSet._capture

    def timed_capture(gs, body):
        t0 = time.perf_counter()
        try:
            return real_capture(gs, body)
        finally:
            spans[gs.tag].append((t0, time.perf_counter(), "capture"))

    graphs.GraphSet._capture = timed_capture

    def engines():
        out = []
        for i, m in enumerate(models):
            e = ServingEngine(m, max_slots=SLOTS, max_len=1024, decode_block=8, paged=True,
                              page_size=16, device=dev)
            e._graphs.tag = i
            out.append(e)
        return out

    def run(engine, i, streams, errors, barrier=None):
        if barrier is not None:
            barrier.wait()
        t0 = time.perf_counter()
        try:
            for s in range(N_SERVES):
                reqs = requests(i, s)
                engine.serve(reqs)
                streams.append([r.out_tokens for r in reqs])
        except Exception as e:    # noqa: BLE001 — reported, not hidden
            errors.append(f"thread {i}: {type(e).__name__}: {str(e).splitlines()[0]}")
            traceback.print_exc()
        spans[i].append((t0, time.perf_counter(), "serve"))

    out = dict(torch=torch.__version__, errors=[], rounds=[])
    for _ in range(ROUNDS):
        for k in spans:
            spans[k].clear()
        paged_attention_cuda.launches = 0
        seq_streams, seq_err = {0: [], 1: []}, []
        for i, e in enumerate(engines()):
            run(e, i, seq_streams[i], seq_err)
        torch.cuda.synchronize()
        seq_launches = paged_attention_cuda.launches
        for k in spans:
            spans[k].clear()
        paged_attention_cuda.launches = 0
        con_streams, con_err = {0: [], 1: []}, []
        engs = engines()
        barrier = threading.Barrier(2)
        threads = [threading.Thread(target=run, args=(e, i, con_streams[i], con_err, barrier))
                   for i, e in enumerate(engs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        try:
            torch.cuda.synchronize()
        except Exception as e:    # noqa: BLE001
            con_err.append(f"synchronize: {type(e).__name__}: {str(e).splitlines()[0]}")
        con_launches = paged_attention_cuda.launches
        serve_span = {i: next(s for s in spans[i] if s[2] == "serve") for i in spans}
        captures = [(i, s) for i in spans for s in spans[i] if s[2] == "capture"]
        overlapped = sum(1 for i, (a, b, _) in captures
                         if a < serve_span[1 - i][1] and b > serve_span[1 - i][0])
        dispatches = sum(e.n_decode_calls for e in engs)
        want = dispatches * 8 * models[0].cfg.n_layers
        out["rounds"].append(dict(
            sequential_errors=seq_err, concurrent_errors=con_err,
            streams_identical=con_streams == seq_streams,
            launches_sequential=seq_launches, launches_concurrent=con_launches,
            launches_expected=want, captures=len(captures),
            captures_overlapping_other_thread=overlapped,
            replays=sum(e._graphs.n_replays for e in engs)))
        out["errors"] += seq_err + con_err
        if con_err:
            break                     # the context may be unusable now
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_capture_threads: needs a CUDA device", file=sys.stderr)
        return 1
    res = rounds()
    print(json.dumps(res), flush=True)
    ok = not res["errors"] and all(
        r["streams_identical"]
        and r["launches_concurrent"] == r["launches_sequential"] == r["launches_expected"]
        for r in res["rounds"])
    print(f"GraphSet: {'safe' if ok else 'NOT SAFE'} under concurrent captures")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
