#!/usr/bin/env python3
"""The WKV6 and RG-LRU backward kernels beside another tree's, on one card.

    python3 benchmarks/torch_recurrent_bwd.py [--parent DIR] [--rglru-chunk N ...]
        [--version NAME=CSRC ...] [--rounds 2]

At paths n's and o's shapes in ``chip_smoke.py`` (RWKV6-3B trained on 4 x
512 tokens: r/k/v/dO (4, 512, 40, 64) bf16 with RWKV6's own decays, no
carried state; RecurrentGemma-9B on 2 x 3,072: x/dh (2, 3072, 4096) bf16
with log-gates −|N(0, 0.5)|, no carried state) this script compiles
``rwkv6_scan.cu``, ``rwkv6_scan_bwd.cu``, ``rglru_scan.cu`` and
``rglru_scan_bwd.cu`` of each version with ``nvcc`` and the port's flags into the gitignored
``build/repro_torch_kernels/``, every ``nvcc`` started together:

* ``tree``: ``src/repro_torch/csrc`` as it is, built by the port's own
  ``kernels.build`` and called through the port's wrappers
  (``wkv6_backward_cuda``, ``rglru_backward_cuda``, ``wkv6_cuda``,
  ``rglru_cuda``), the scratch they hold across calls included;
* ``parent``: the ``src/repro_torch/csrc`` under ``DIR`` (another commit
  unpacked there with ``git archive <commit> src/repro_torch/csrc | tar -x
  -C DIR``), whose backwards may take other scratch (the C entries are told
  apart by the symbols they export);
* ``rglru_cN``: the tree with the RG-LRU chunk (``C`` in
  ``rglru_chain.cuh``) set to N tokens, its backward only (the chunk the
  tree keeps is ``rglru_scan.CHUNK``; the WKV6 backward's chunk is the
  forward's 32, which its pair tiling assumes, so it has no variant);
* ``NAME``: any other copy of ``src/repro_torch/csrc`` (``--version``), for
  example one with a phase cut out; a name that starts with ``probe`` is
  timed but not held to the plain versions.

Every version but the tree is called through its C entries with ctypes
(``Wkv6Bwd``, ``RglruBwd``, ``wkv6_forward``, ``rglru_forward``), each
with scratch of its own, since its sources need not match the wrappers'.

It prints each build's ptxas lines for the backward kernels, holds each
version's gradients against ``wkv6_backward_plain`` / ``rglru_backward_plain``
(2e-2 row-relative, as ``chip_smoke.py`` holds the kernels), launched twice
(the same bits required), and says whether they are the tree's bits; it
says too whether the WKV6 and RG-LRU forwards' outputs (bf16 and fp32) are
the same bits in every version.  Then each round reads each version's CUPTI device
time a call (its kernels summed, and each alone) from a torch.profiler trace
of 20 calls, each after an L2 flush (a 128 MB write), the versions in turns
and then in the reverse order.  Writes every reading, with the card's name
and power limit from nvidia-smi, to ``chiprun_out/recurrent_bwd.json``.
Exits 1 if a version is wrong.  Needs a CUDA device.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 2e-2                                  # row-relative, bf16
WKV = dict(B=4, T=512, H=40, D=64)
RGLRU = dict(B=2, T=3072, W=4096)
ITERS = 20
SOURCES = ("rwkv6_scan", "rwkv6_scan_bwd", "rglru_scan", "rglru_scan_bwd")


def build_versions(build, versions: dict) -> dict:
    """One library a (version, source), every ``nvcc`` started together:
    the tree's through the port's ``build.build_all`` (loaded later by the
    wrappers), every other version's here; prints the backward kernels'
    ptxas lines.  ``versions`` maps a name to (csrc directory, sources to
    build)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (csrc, sources) in versions.items():
        if name == "tree":
            continue
        for src in sources:
            out = build.BUILD_DIR / f"lib{src}_{name}.so"
            cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                   str(csrc / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), out)
    build.build_all(SOURCES)
    logs = {("tree", src): Path(f"{build.library_path(src)}.log").read_text()
            for src in SOURCES}
    libs, ptxas = {}, {}
    for (name, src), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name} {src}:\n{log}")
        logs[name, src] = log
        libs[name, src] = ctypes.CDLL(str(out))
    for (name, src), log in logs.items():
        entry, spill = "", ""
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                entry = m[1]
            elif "spill" in line:
                spill = re.sub(r".*stack frame, ", "", line.strip())
            elif "Used" in line and "bwd" in entry:
                kernel = re.search(r"(?:wkv6|rglru)_bwd\w*?_kernel", entry)
                text = line.replace("ptxas info    : ", "").strip()
                ptxas.setdefault(name, []).append(f"{kernel[0] if kernel else entry}: {text}; "
                                                  f"{spill}")
                print(f"[{name}] {ptxas[name][-1]}")
    return libs, ptxas


def dw_from_dlw(dlw, w):
    inside = (w >= 1e-12) & (w <= 1.0)
    return torch.where(inside, dlw / torch.where(inside, w, 1.0), 0.0)


class Wkv6Bwd:
    """One call of a version's WKV6 backward C entry, with the scratch it
    takes: the tree's (chunk states, G's slots, flags held across calls) or
    an earlier one's (a state saved every few tokens)."""

    def __init__(self, lib, dev):
        self.fn = lib.repro_wkv6_bwd
        self.chunked = hasattr(lib, "repro_wkv6_bwd_chunk")
        n_ptr = 4 if self.chunked else 2
        self.fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * n_ptr
        self.fn.restype = ctypes.c_int
        self.step = lib.repro_wkv6_bwd_chunk() if self.chunked else lib.repro_wkv6_bwd_sub()
        B, H = WKV["B"], WKV["H"]
        self.sync = torch.zeros(B * H + 1, dtype=torch.int32, device=dev)

    def __call__(self, r, k, v, w, u, do):
        B, T, H, D = r.shape
        n = -(-T // self.step)
        dr, dk, dv, dlw = (torch.empty_like(x) for x in (r, k, v, w))
        du = torch.empty((H, D), dtype=torch.float32, device=r.device)
        ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
        if self.chunked:
            du_rows = torch.empty((B, n, H, D), dtype=torch.float32, device=r.device)
            states = torch.empty(B * H * n * D * D, dtype=torch.float32, device=r.device)
            slots = torch.empty(B * H * 2 * D * D, dtype=torch.float32, device=r.device)
            scratch = (states.data_ptr(), slots.data_ptr(), self.sync.data_ptr())
        else:
            du_rows = torch.empty((B, H, D), dtype=torch.float32, device=r.device)
            saved = torch.empty(B * H * n * D * D, dtype=torch.float32, device=r.device)
            scratch = (saved.data_ptr(),)
        err = self.fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      None, do.data_ptr(), None, dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dlw.data_ptr(), du_rows.data_ptr(), du.data_ptr(), ds0.data_ptr(), B, T,
                      H, D, 1, *scratch, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"WKV6 backward launch failed with CUDA error {err}")
        return dr, dk, dv, dw_from_dlw(dlw, w), du.to(u.dtype), ds0


class RglruBwd:
    """One call of a version's RG-LRU backward C entry: the tree's chunk
    chains (chunk states and the zeroed words) or an earlier one's (every
    token's state)."""

    def __init__(self, lib, dev, chunk):
        self.fn = lib.repro_rglru_scan_bwd
        self.chunk = chunk
        self.chunked = chunk is not None
        self.fn.argtypes = ([ctypes.c_void_p] * (10 if self.chunked else 9)
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int
        B, T, W = RGLRU["B"], RGLRU["T"], RGLRU["W"]
        self.words = (torch.zeros(1 + (-(-T // chunk) - 1) * B * W, dtype=torch.int64,
                                  device=dev) if self.chunked else None)

    def __call__(self, x, a_log, dh):
        B, T, W = x.shape
        dx, da = torch.empty_like(x), torch.empty_like(a_log)
        d0 = torch.empty((B, W), dtype=torch.float32, device=x.device)
        if self.chunked:
            h_start = torch.empty((B, -(-T // self.chunk), W), dtype=torch.float32,
                                  device=x.device)
            scratch = (h_start.data_ptr(), self.words.data_ptr())
        else:
            h_in = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
            scratch = (h_in.data_ptr(),)
        err = self.fn(x.data_ptr(), a_log.data_ptr(), None, dh.data_ptr(), None, dx.data_ptr(),
                      da.data_ptr(), d0.data_ptr(), *scratch, B, T, W, 1,
                      torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"RG-LRU backward launch failed with CUDA error {err}")
        return dx, da, d0


def wkv6_forward(lib, r, k, v, w, u):
    """One call of a version's WKV6 forward C entry (the prefill at T > 1)."""
    fn = lib.repro_wkv6
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, T, H, D = r.shape
    state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    o, s_out = torch.empty_like(r), torch.empty_like(state)
    scratch = torch.empty(B * H * (2 * D * D + 1) + 1, dtype=torch.float32, device=r.device)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
             state.data_ptr(), o.data_ptr(), s_out.data_ptr(), scratch.data_ptr(), B, T, H, D,
             0 if r.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"WKV6 forward launch failed with CUDA error {err}")
    return o, s_out


def rglru_forward(lib, x, a_log, chunk):
    """One call of a version's RG-LRU forward C entry."""
    fn = lib.repro_rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, T, W = x.shape
    state = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    out, h_out = torch.empty_like(x), torch.empty_like(state)
    words = torch.zeros(1 + (-(-T // chunk) - 1) * B * W, dtype=torch.int64, device=x.device)
    err = fn(x.data_ptr(), a_log.data_ptr(), state.data_ptr(), out.data_ptr(), h_out.data_ptr(),
             words.data_ptr(), B, T, W, 0 if x.dtype == torch.float32 else 1,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU forward launch failed with CUDA error {err}")
    return out, h_out


def same_bits(tree_forward, forward, versions, libs, src, *args):
    """Whether each version's forward gives the tree's outputs (the tree's
    through its wrapper, ``tree_forward``)."""
    base = tree_forward(*args)
    same = {"tree": True}
    for name in versions:
        if (name, src) in libs:
            got = forward(libs[name, src], *args)
            same[name] = all(bool(torch.equal(a, b)) for a, b in zip(got, base))
    return same


def row_rel_err(got, want):
    """Max over rows of max|got − want| over the row's max|want| (as chip_smoke.py)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp(min=1e-6)).max().item()


def cupti_ms(fn, flush, frag):
    """CUPTI device time of one call of ``fn`` (every kernel whose name holds
    ``frag``) and of each kernel alone, over ``ITERS`` calls, each after an
    L2 flush; with the records kept a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.count and e.self_device_time_total > 0
            and frag in e.key]
    per = {re.sub(r"\(.*\)$", "", e.key.replace("(anonymous namespace)::", ""))[-60:]:
           e.self_device_time_total / min(e.count, ITERS) / 1e3 for e in rows}
    return dict(ms=sum(per.values()) if per else None, kernels=per,
                records_a_call=min((e.count / ITERS for e in rows), default=0.0))


def check_version(name, got, again, want, tree, names):
    rec = dict(errors={n: row_rel_err(a, w) for n, a, w in zip(names, got, want)},
               identical=all(torch.equal(a, b) for a, b in zip(got, again)),
               tree_bits=tree is not None and all(torch.equal(a, b) for a, b in zip(got, tree)),
               ms=[])
    print(f"{name}: row-relative {', '.join(f'{n} {e:.3g}' for n, e in rec['errors'].items())}"
          f"; two launches {'identical' if rec['identical'] else 'DIFFER'}; the tree's bits: "
          f"{rec['tree_bits']}", flush=True)
    return rec, rec["identical"] and max(rec["errors"].values()) <= TOL


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a directory holding an earlier "
                    "src/repro_torch/csrc")
    ap.add_argument("--rglru-chunk", type=int, action="append", default=[],
                    help="also build the RG-LRU backward at this chunk")
    ap.add_argument("--version", action="append", default=[], metavar="NAME=CSRC",
                    help="another copy of src/repro_torch/csrc to build and time")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_recurrent_bwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import CHUNK as RGLRU_CHUNK
    from repro_torch.kernels.rglru_scan import (rglru_backward_cuda, rglru_backward_plain,
                                                rglru_cuda)
    from repro_torch.kernels.rwkv6_scan import CHUNK as WKV6_CHUNK
    from repro_torch.kernels.rwkv6_scan import (wkv6_backward_cuda, wkv6_backward_plain,
                                                wkv6_cuda)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"chunks kept: WKV6 backward {WKV6_CHUNK} tokens (the forward's), RG-LRU backward "
          f"{RGLRU_CHUNK}; tried here beside them: RG-LRU {args.rglru_chunk or 'none'}")
    versions = {"tree": (build.CSRC, SOURCES)}
    if args.parent:
        versions["parent"] = ((args.parent / "src/repro_torch/csrc").resolve(), SOURCES)
    for spec in args.version:
        name, _, path = spec.partition("=")
        versions[name] = (Path(path).resolve(), SOURCES)
    chunks = {"tree": RGLRU_CHUNK}
    for n in args.rglru_chunk:
        csrc = build.BUILD_DIR.parent / f"rglru_c{n}"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(build.CSRC, csrc)
        chain = csrc / "rglru_chain.cuh"
        text, hits = re.subn(r"constexpr int C = \d+;", f"constexpr int C = {n};",
                             chain.read_text())
        if hits != 1:
            raise SystemExit("rglru_chain.cuh: the chunk constant was not found")
        chain.write_text(text)
        versions[f"rglru_c{n}"] = (csrc, ("rglru_scan_bwd",))
        chunks[f"rglru_c{n}"] = n
    libs, ptxas = build_versions(build, versions)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(nvidia_smi=smi, wkv6_shape=WKV, rglru_shape=RGLRU, ptxas=ptxas,
               chunks=dict(wkv6=WKV6_CHUNK, rglru=chunks), wkv6={}, rglru={}, forward={})
    ok = True

    # ---- WKV6: inputs as path n's, bf16, RWKV6's own decays, no state ----
    B, T, H, D = WKV["B"], WKV["T"], WKV["H"], WKV["D"]
    r, k, v, do = (torch.randn(B, T, H, D, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    w = torch.exp(-torch.exp(torch.rand((B, T, H, D), device=dev, generator=gen) - 0.5))
    u = (torch.rand((H, D), device=dev, generator=gen) - 0.5).to(torch.bfloat16)
    want = wkv6_backward_plain(r, k, v, w, u, do)
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    wkv6_calls, tree = {}, None
    for name in versions:
        if name == "tree":
            call = lambda r, k, v, w, u, do: wkv6_backward_cuda(r, k, v, w, u, do)  # noqa: E731
        elif (name, "rwkv6_scan_bwd") in libs:
            call = Wkv6Bwd(libs[name, "rwkv6_scan_bwd"], dev)
        else:
            continue
        got, again = call(r, k, v, w, u, do), call(r, k, v, w, u, do)
        torch.cuda.synchronize()
        tree = tree or got
        out["wkv6"][name], good = check_version(f"wkv6_bwd {name}", got, again, want, tree,
                                                names)
        ok &= good or name.startswith("probe")
        wkv6_calls[name] = (lambda call=call: call(r, k, v, w, u, do))
        del got, again
    del want
    # the forward's outputs, whose source moved into a header shared with the backward
    fwd = {str(dtype): same_bits(wkv6_cuda, wkv6_forward, versions, libs, "rwkv6_scan",
                                 r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype))
           for dtype in (torch.bfloat16, torch.float32)}
    out["forward"]["wkv6"] = fwd
    print(f"wkv6 forward, the same bits as the tree's: {fwd}", flush=True)

    # ---- RG-LRU: inputs as path o's, bf16, no state ----
    Bg, Tg, W = RGLRU["B"], RGLRU["T"], RGLRU["W"]
    x, dh = (torch.randn(Bg, Tg, W, device=dev, generator=gen).to(torch.bfloat16)
             for _ in range(2))
    a_log = -(0.5 * torch.randn((Bg, Tg, W), device=dev, generator=gen)).abs()
    # the forward, whose block moved into a header shared with the backward
    fwd = {str(dtype): same_bits(lambda x, a_log, _: rglru_cuda(x, a_log), rglru_forward,
                                 versions, libs, "rglru_scan", x.to(dtype), a_log, RGLRU_CHUNK)
           for dtype in (torch.bfloat16, torch.float32)}
    out["forward"]["rglru"] = fwd
    print(f"rglru forward, the same bits as the tree's: {fwd}", flush=True)
    want = rglru_backward_plain(x, a_log, dh)
    rglru_calls, tree = {}, None
    for name in versions:
        if name == "tree":
            call = rglru_backward_cuda
        elif (name, "rglru_scan_bwd") in libs:
            chunked = name != "parent" or _takes_chunk_scratch(args.parent)
            call = RglruBwd(libs[name, "rglru_scan_bwd"], dev,
                            chunks.get(name, RGLRU_CHUNK) if chunked else None)
        else:
            continue
        got, again = call(x, a_log, dh), call(x, a_log, dh)
        torch.cuda.synchronize()
        tree = tree or got
        out["rglru"][name], good = check_version(f"rglru_bwd {name}", got, again, want, tree,
                                                 ("dx", "da_log", "dstate"))
        ok &= good or name.startswith("probe")
        rglru_calls[name] = (lambda call=call: call(x, a_log, dh))
        del got, again
    del want

    # ---- CUPTI in turns ----
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for key, calls, frag in (("wkv6", wkv6_calls, "wkv6_bwd"), ("rglru", rglru_calls,
                                                                 "rglru_bwd")):
        order = list(calls)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                out[key][name]["ms"].append(cupti_ms(calls[name], flush, frag))
        for name in order:
            ms = out[key][name]["ms"]
            print(f"{key}_bwd {name}: CUPTI ms a call "
                  f"{[r_['ms'] and round(r_['ms'], 4) for r_ in ms]} (records a call "
                  f"{min(r_['records_a_call'] for r_ in ms)}); kernels "
                  f"{ {kn: round(t, 4) for kn, t in ms[0]['kernels'].items()} }", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "recurrent_bwd.json").write_text(json.dumps(out, indent=1))
    print(f"versions {'right' if ok else 'WRONG'}")
    return 0 if ok else 1


def _takes_chunk_scratch(parent):
    """Whether an earlier tree's RG-LRU backward takes the chunk chains'
    scratch: its source defines the states kernel."""
    src = parent / "src/repro_torch/csrc/rglru_scan_bwd.cu"
    return "rglru_bwd_states_kernel" in src.read_text()


if __name__ == "__main__":
    sys.exit(main())
