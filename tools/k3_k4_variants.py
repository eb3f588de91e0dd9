"""Time K3 and K4 (``csrc/score_count.cu``) against the kernel they replaced
and against variants of their own source.

The baseline is the replaced source, kept in this file as it was:

  prev       one thread a row, a 1-byte mask load, every value loaded
             (K4: all three) whatever the mask, a scalar store, a grid
             capped at 132 x 16 blocks, the count zeroed by a
             cudaMemsetAsync and summed with one atomicAdd a block: two
             launches a call.

The committed source and its variants (each the committed source with a
line or a block replaced):

  r4, r8, r16  4, 8 or 16 rows a thread (the committed value is one of
               them: "new" below names it)
  flip         the committed source with its warp skip (kWarpSkip) the
               other way round
  cap2, cap4   a grid of at most 2 or 4 blocks an SM, the loop striding,
               against the committed full grid
  memset       the count by a cudaMemsetAsync and one atomicAdd a block
               (two launches a call), against one 64-bit atomic a block
               that adds the block's count and its ticket at once
  acc          an accumulator and a ticket, two atomics a block and a
               fence between them
  partials     a partial a block in the scratch, summed by the last block
               to take the ticket (at most 8,192 blocks, the loop striding
               beyond)

Every library is built with the port's nvcc flags (one ``nvcc`` each, all
started together).  Each is checked bit for bit (NaN payloads included;
the previous kernel, which flips a NaN's sign bit and orders -0 and +0
otherwise than ``torch.minimum``, by value with NaN rows equal) with an
exact count against ``score_count_plain`` / ``score3_count_plain`` on the
rows below; on tails (n = 1, 3, 5, 7, 9, 15, 17, 255, 257, 4095, 4097,
2**24 + 3); on the mask and the values viewed at a 1-element offset; on
all-false and all-true masks; with NaN, +-inf and +-0 in each value array
at selected and unselected rows.  A variant that differs is not timed;
the previous kernel is timed all the same, as the baseline.  Then every row is timed in
turns, the variants in order and then in reverse: the median over
replays of a CUDA graph of 50 calls between two CUDA events, per call,
warm (the inputs left in the 50 MB L2 by the call before) and cold (each
call after a 128 MiB write that flushes the L2; the graph of the writes
alone is timed beside it and taken off).  Issued one by one, a few us of
kernel would wait on tens of us of host.

The rows are the ones the port's paths give the kernels.  The script runs
the iso and the tensor path of ``chip_smoke.py`` once each, recording
every K3 and K4 call's rows and selected rows (``chip_smoke._ScoreTap``,
which wraps the wrappers there, not in the package), prints their median
and largest rows and selected shares, runs each path again to capture the
inputs of the call with the most rows and of the one with the largest
selected share, and builds chip_smoke.py's own [kernel] rows from the iso
path's output (``chip_smoke._score_fixtures``).  The verdict line of each
row says whether the committed kernel is at or below the previous one in
every turn, warm and cold; the script exits 1 unless it is on every row.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k3_k4_variants.py
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "parmmg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k3_k4_variants")

# the previous csrc/score_count.cu, as it was
PREV = r"""// Candidate scoring for a wave's top-k cut: out = mask ? -v : -inf, plus the
// exact int32 count of the mask.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:score_count_pallas
// (_score_kernel) and score3_count_pallas (_score_min3_kernel, where
// v = min(v0, min(v1, v2)) in that association).  The Pallas count relied on
// the TPU's sequential grid (cnt += ... across grid steps).  A CUDA grid has
// no order, so each block reduces its share with warp shuffles and adds it
// with ONE integer atomicAdd: integer addition is associative, so the count
// is exact and independent of block order.
//
// Bound on the card: bytes.  Per element it reads 1 byte of mask and 4 (K3)
// or 12 (K4) bytes of values and writes 4; least time = bytes / 3.35 TB/s.
// Design: grid-stride loop, coalesced loads, one atomic per block (at most
// 132*16 atomics on one address, negligible).  The mask is taken as bytes
// (torch bool), not as the TPU's float32 view.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// torch.minimum semantics: NaN propagates
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

template <bool MIN3>
__global__ void score_kernel(const uint8_t* __restrict__ mask,
                             const float* __restrict__ v0,
                             const float* __restrict__ v1,
                             const float* __restrict__ v2,
                             float* __restrict__ out, int* __restrict__ cnt,
                             long long n) {
  int local = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const bool sel = mask[i] != 0;
    float v = v0[i];
    if (MIN3) v = min_nan(v, min_nan(v1[i], v2[i]));
    out[i] = sel ? -v : -INFINITY;
    local += sel ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, o);
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = local;
  __syncthreads();
  if (wid == 0) {
    local = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, o);
    if (lane == 0 && local != 0) atomicAdd(cnt, local);
  }
}

template <bool MIN3>
int launch(const uint8_t* mask, const float* v0, const float* v1,
           const float* v2, float* out, int* cnt, long long n,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  score_kernel<MIN3><<<(unsigned)blocks, threads, 0, s>>>(mask, v0, v1, v2,
                                                          out, cnt, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pm_score_count(const uint8_t* mask, const float* v,
                              float* out, int* cnt, long long n,
                              void* stream) {
  return launch<false>(mask, v, nullptr, nullptr, out, cnt, n, stream);
}

extern "C" int pm_score3_count(const uint8_t* mask, const float* v0,
                               const float* v1, const float* v2, float* out,
                               int* cnt, long long n, void* stream) {
  return launch<true>(mask, v0, v1, v2, out, cnt, n, stream);
}
"""

_ROWS = re.compile(r"constexpr int kRows = (\d+);")
_SKIP = re.compile(r"constexpr bool kWarpSkip = (true|false);")
_GRID = "  if (blocks < 1) blocks = 1;\n"
_GRID_SM = """\
  if (blocks < 1) blocks = 1;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > (long long)sms * {cap}) blocks = (long long)sms * {cap};
"""
_GRID_PARTIALS = """\
  if (blocks < 1) blocks = 1;
  if (blocks > 8192) blocks = 8192;
"""
_SCRATCH = "extern \"C\" int pm_score_scratch_ints() { return 2; }\n"
_SCRATCH_PARTIALS = ("extern \"C\" int pm_score_scratch_ints() "
                     "{ return 1 + 8192; }\n")
_LAUNCH = "  cudaStream_t s = (cudaStream_t)stream;\n"
_MEMSET = """\
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
"""
_COUNT0 = ("  // count: one 64-bit word, the blocks done above the count "
           "so far\n")
_COUNT1 = "  // end count\n"
_COUNT_MEMSET = """\
  if (threadIdx.x == 0) {
    int b = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) b += warp_sum[k];
    if (b) atomicAdd(cnt, b);
  }
"""
# an accumulator in ctrl[1] and a ticket in ctrl[0], two atomics a block
# and a fence between them
_COUNT_ACC = """\
  if (threadIdx.x == 0) {
    int b = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) b += warp_sum[k];
    if (b) atomicAdd(ctrl + 1, b);
    __threadfence();
    if (atomicAdd(reinterpret_cast<unsigned*>(ctrl), 1u) == gridDim.x - 1) {
      __threadfence();
      *cnt = atomicExch(ctrl + 1, 0);
      ctrl[0] = 0;
    }
  }
"""
# a partial a block in ctrl[1 + block], summed by the last block
_COUNT_PARTIALS = """\
  __shared__ bool last;
  if (threadIdx.x == 0) {
    int b = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) b += warp_sum[k];
    ctrl[1 + blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(ctrl), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int s = 0;
  for (unsigned k = threadIdx.x; k < gridDim.x; k += kThreads)
    s += __ldcg(ctrl + 1 + k);
  s = __reduce_add_sync(kFull, s);
  __syncthreads();
  if (lane == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) t += warp_sum[k];
    *cnt = t;
    ctrl[0] = 0;
  }
"""


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _patch(text: str, *pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds, once:\n{old}")
        text = text.replace(old, new)
    return text


def _count_region(text: str, new: str) -> str:
    """``text`` with the block from the count's first marker line to its
    last replaced by ``new``."""
    i, j = text.index(_COUNT0), text.index(_COUNT1) + len(_COUNT1)
    return text[:i] + new + text[j:]


def variants():
    """(the committed variant's name, {variant: CUDA source})."""
    src = _read("score_count.cu")
    rows, skip = _ROWS.search(src), _SKIP.search(src)
    if not rows or not skip:
        raise RuntimeError("the source's kRows or kWarpSkip line moved")
    out = {"prev": PREV}
    for r in (4, 8, 16):
        out[f"r{r}"] = _patch(src, (rows.group(0),
                                    f"constexpr int kRows = {r};"))
    flip = "false" if skip.group(1) == "true" else "true"
    out["flip"] = _patch(src, (skip.group(0),
                               f"constexpr bool kWarpSkip = {flip};"))
    for c in (2, 4):
        out[f"cap{c}"] = _patch(src, (_GRID, _GRID_SM.format(cap=c)))
    out["memset"] = _count_region(_patch(src, (_LAUNCH, _MEMSET)),
                                  _COUNT_MEMSET)
    out["acc"] = _count_region(src, _COUNT_ACC)
    out["partials"] = _count_region(_patch(
        src, (_GRID, _GRID_PARTIALS), (_SCRATCH, _SCRATCH_PARTIALS)),
        _COUNT_PARTIALS)
    return f"r{rows.group(1)}", out


def build(srcs: dict, out: str = OUT) -> dict:
    """variant -> loaded library, each built under ``out``; a variant that
    fails to build is printed and left out."""
    from parmmg_tpu_torch.ops import cuda_build
    procs = {}
    for name, text in srcs.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        src, lib = os.path.join(d, "k.cu"), os.path.join(d, "lib.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
             "-Xptxas", "-v", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"[build] {name}: nvcc exit {p.returncode}; "
              + " | ".join(regs))
        if p.returncode:
            print(out[-3000:])
        else:
            libs[name] = ctypes.CDLL(lib)
    return libs


def _bind(lib, sym, argtypes):
    f = getattr(lib, sym)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def use(lib) -> None:
    """Point the port's K3 / K4 wrappers at the library ``lib``, with fresh
    (zeroed) scratch."""
    from parmmg_tpu_torch.ops import kernels as K
    for sym in ("pm_score_count", "pm_score3_count", "pm_score_scratch_ints"):
        K._FNS[sym] = _bind(lib, sym, K._SIGS[sym][1])
    K._TILES.pop("pm_score_scratch_ints", None)
    for key in [k for k in K._SCRATCH if k[0] in ("score_count",
                                                   "score3_count")]:
        del K._SCRATCH[key]


def prev_fns(lib):
    """The previous kernel as (score_count, score3_count): two launches a
    call, the count's memset and the kernel."""
    import torch
    from parmmg_tpu_torch.ops import kernels as K
    P, N = ctypes.c_void_p, ctypes.c_longlong
    k3 = _bind(lib, "pm_score_count", [P, P, P, P, N, P])
    k4 = _bind(lib, "pm_score3_count", [P, P, P, P, P, P, N, P])

    def call(f, mask, *vals):
        n = mask.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=mask.device)
        cnt = torch.empty(1, dtype=torch.int32, device=mask.device)
        rc = f(mask.data_ptr(), *(v.data_ptr() for v in vals),
               out.data_ptr(), cnt.data_ptr(), n, K._stream(out))
        if rc:
            raise RuntimeError(f"the previous K3 / K4: CUDA error {rc}")
        return out, cnt[0]
    return ((lambda m, v: call(k3, m, v)),
            (lambda m, v0, v1, v2: call(k4, m, v0, v1, v2)))


def _bits(out):
    import torch
    return torch.cat([out[0].view(torch.int32), out[1].view(1)])


def check(k3, k4, rows, dev, strict=True) -> str:
    """'' when ``k3`` / ``k4`` equal the plain versions bit for bit with an
    exact count on the rows and every case below, else the first case that
    differs.  ``strict=False`` holds the scores to equal values and NaN
    rows, as ``torch.equal`` on floats does but for NaN: the previous kernel
    flips a NaN's sign bit where PyTorch's negation on the card gives the
    canonical NaN, and its min orders -0 and +0 otherwise than
    ``torch.minimum``."""
    import torch
    from parmmg_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cases = [(label, args) for label, args in rows.items()]
    specials = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0)
    for n in (1, 3, 5, 7, 9, 15, 17, 255, 257, 4095, 4097, 2 ** 24 + 3):
        vals = torch.rand((3, n + 1), generator=gen, device=dev)
        pick = torch.randint(0, 40, (3, n + 1), generator=gen, device=dev)
        for code, x in enumerate(specials):
            vals = torch.where(pick == code, x, vals)
        masks = {"random": torch.rand(n + 1, generator=gen, device=dev) < 0.3,
                 "all-false": torch.zeros(n + 1, dtype=torch.bool,
                                          device=dev),
                 "all-true": torch.ones(n + 1, dtype=torch.bool, device=dev)}
        for kind, mask in masks.items():
            for mo, vo in ((0, 0), (1, 1), (1, 0), (0, 1)):
                m = mask[mo:mo + n]
                vs = tuple(vals[k, vo:vo + n] for k in range(3))
                what = (f"n={n} {kind} mask at offset {mo}, values at offset "
                        f"{vo}")
                cases += [(f"K3 {what}", (m, vs[0])), (f"K4 {what}", (m, *vs))]
    for label, args in cases:
        fn, plain = ((k4, K.score3_count_plain) if label.startswith("K4")
                     else (k3, K.score_count_plain))
        got, ref = fn(*args), plain(*args)
        if strict:
            same = torch.equal(_bits(got), _bits(ref))
        else:
            nan = torch.isnan(ref[0])
            same = (torch.equal(torch.isnan(got[0]), nan)
                    and torch.equal(got[0].masked_fill(nan, 0),
                                    ref[0].masked_fill(nan, 0))
                    and int(got[1]) == int(ref[1]))
        if not same:
            return label
    return ""


def batch_ms(fn, stream, flush=None, reps: int = 50,
             batches: int = 7) -> float:
    """Median over ``batches`` replays of a CUDA graph of ``reps`` calls of
    ``fn`` on ``stream``, between two CUDA events, per call.  With
    ``flush`` (a 128 MiB buffer) every call follows a write of it, and the
    same graph of the writes alone, replayed in turns with it, is taken
    off batch by batch."""
    import torch

    def graph(body):
        with torch.cuda.stream(stream):
            for _ in range(3):
                body()
        stream.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(reps):
                body()
        g.replay()
        torch.cuda.synchronize()
        return g

    def timed(g):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            a.record()
            g.replay()
            b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    if flush is None:
        g = graph(fn)
        ts = sorted(timed(g) for _ in range(batches))
    else:
        g = graph(lambda: (flush.zero_(), fn()))
        g0 = graph(flush.zero_)
        ts = sorted(timed(g) - timed(g0) for _ in range(batches))
        del g0
    del g
    torch.cuda.empty_cache()         # the graphs' outputs, 50 a graph
    return ts[len(ts) // 2]


def path_rows():
    """{label: K3 (mask, values) or K4 (mask, v0, v1, v2)}: chip_smoke.py's
    [kernel] K3 and K4 inputs on the iso path's output, and the K3 / K4
    calls of the iso and tensor paths with the most rows and with the
    largest selected share (labels start with "K3" or "K4")."""
    import chip_smoke as cs
    from parmmg_tpu_torch.ops import kernels as K
    from parmmg_tpu_torch.ops.edges import unique_edges
    wd = os.path.join(OUT, "smoke")
    os.makedirs(wd, exist_ok=True)
    samples, shapes = {}, {}
    for stem in ("cube16", "cube16ani"):
        _, shapes[stem] = cs.phase_path(wd, stem)
        calls, picks = cs._score_want(shapes[stem], ("largest", "densest"))
        with cs._ScoreTap(i for p in picks.values()
                          for i in p.values()) as tap:
            cs._run_main(wd, stem, os.path.join(wd, f"{stem}.r2.mesh"))
        samples[stem] = cs._score_capture(tap, calls, picks)
    mesh, met, _ = cs._read_output(os.path.join(wd, "cube16.o.mesh"),
                                   capP=shapes["cube16"]["capP"],
                                   capT=shapes["cube16"]["capT"])
    et = unique_edges(mesh)
    lens = K.edge_lengths_iso(mesh.vert, met, et.ev.contiguous())
    cand, neg, c3, v0, v1, v2 = cs._score_fixtures(mesh, et, lens)
    rows = {f"K3 fixture [{cand.shape[0]}, {int(cand.sum())} selected]":
            (cand, neg),
            f"K4 fixture [{c3.shape[0]}, {int(c3.sum())} selected]":
            (c3, v0, v1, v2)}
    for name, tag in (("score_count", "K3"), ("score3_count", "K4")):
        for pick, key in (("largest", lambda c: (c[2], c[3])),
                          ("densest", lambda c: (c[3] / max(c[2], 1), c[2]))):
            stem, ins, n, sel = max(((stem, *cap[name][pick]) for stem, cap
                                     in samples.items() if name in cap),
                                    key=key)
            rows[f"{tag} {pick} call of {stem} [{n}, {sel} selected]"] = ins
    return rows


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from parmmg_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    new, srcs = variants()
    libs = build(srcs)
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s; the committed source is {new}")
    rows = path_rows()
    fns = {}
    for name, lib in libs.items():
        try:
            if name == "prev":
                k3, k4 = prev_fns(lib)
            else:
                use(lib)
                k3, k4 = K.score_count, K.score3_count
            bad = check(k3, k4, rows, dev, strict=name != "prev")
        except Exception as ex:          # a variant that faults is dropped
            bad = repr(ex)
        print(f"[check] {name}: "
              + (f"DIFFERS: {bad}" if bad else "equal on every case"))
        if name == new and bad:
            print("[verdict] the committed kernel is wrong")
            return 1
        if not bad or name == "prev":
            fns[name] = (lib, k3, k4)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device=dev)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    res: dict = {}
    for turn in range(2):
        for label, args in rows.items():
            names = list(fns) if turn == 0 else list(fns)[::-1]
            for name in names:
                lib, f3, f4 = fns[name]
                if name != "prev":
                    use(lib)
                f = f4 if label.startswith("K4") else f3

                def fn(f=f, args=args):
                    return f(*args)
                warm, cold = batch_ms(fn, stream), batch_ms(fn, stream, flush)
                res.setdefault((label, name), []).append((warm, cold))
                print(f"[turn {turn + 1}] {label:52s} {name:6s} graph ms "
                      f"warm {warm:.5f} cold {cold:.5f}", flush=True)
    fail = False
    for label in rows:
        base = res[(label, "prev")]
        bw, bc = min(x[0] for x in base), min(x[1] for x in base)
        parts = []
        for name in fns:
            w = [x[0] for x in res[(label, name)]]
            c = [x[1] for x in res[(label, name)]]
            parts.append(f"{name} warm {min(w):.5f}-{max(w):.5f} cold "
                         f"{min(c):.5f}-{max(c):.5f} ({min(w) / bw:.3f}x / "
                         f"{min(c) / bc:.3f}x prev)")
        ok = all(a[0] <= b[0] and a[1] <= b[1]
                 for a, b in zip(res[(label, new)], base))
        fail = fail or not ok
        print(f"[verdict] {label}: best-worst of 2 turns: {'; '.join(parts)}"
              f"; {new} at or below prev in every turn, warm and cold: {ok}")
    print(cs._card_line())
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
