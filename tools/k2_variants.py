"""Time K2 (``csrc/edge_length_ani.cu``) against the kernel it replaced and
against variants of its own source.

The baseline is the replaced source, kept in this file as it was:

  prev       one thread a row, every row evaluated (two 4-byte id loads,
             18 scalar endpoint gathers, a scalar store), a grid capped at
             132 x 16 blocks, the loop striding.

The committed source and its variants (each the committed source with a
line or a block replaced):

  r2, r4, r8  2, 4 or 8 rows a thread (the committed value is one of them:
              "new" below names it)
  noreuse     every row evaluated (kReuse false)
  nocross     no run carried across lanes: a lane's first row of a group
              is evaluated (kCrossLane false)
  lanes       each lane evaluates its own heads, instead of the warp's
              heads dealt out to its 32 lanes (kCompact false)
  capN        a grid of at most N blocks an SM (6, 12, 16), the loop
              striding (prev's cap was 16 of 132 SMs), against the
              committed full grid
  noldg       the endpoint gathers by plain loads, not ``__ldg``
  metsc       the tensor rows as six 4-byte loads
  wide        an endpoint's rows in two loads each, not three and three:
              the point row as a float2 and a float, the tensor row as a
              float4 and a float2, split by the id's parity
  stream      the ids and lengths by evict-first accesses (``__ldcs``,
              ``__stcs``)

Every library is built with the port's nvcc flags (one ``nvcc`` each, all
started together).  Each is checked against ``prev`` bit for bit on every
row, except the rows where ``prev`` turned a NaN quadratic form into 0
(CUDA's ``fmaxf(NaN, 0)`` is 0; the plain version, the JAX package and the
committed kernel keep it NaN), which must be NaN; and within 3e-5 / 3e-6
of ``edge_lengths_ani_plain``, NaN where it is NaN (``prev`` on the rows
it did not zero).  The cases: the rows below, and every case of
``chip_smoke._k2_cases`` at each size of ``chip_smoke.K2_SIZES`` (tails of
1-9, 255, 257, 4097 and 2**24 + 3 rows; sorted runs with an INT32_MAX
tail, the same at a one-row offset, ids out of range, a long INT32_MAX
tail, unsorted ids, NaN and +-inf in point and tensor rows, the tensors
at a one-float offset).  A variant that differs is not timed.  Then every
row is timed in turns, the variants in order and then in reverse: the
median over replays of a CUDA graph of 50 calls between two CUDA events,
per call, warm and cold (each call after a 128 MiB write that flushes
the L2, the graph of the writes alone taken off;
``k3_k4_variants.batch_ms``).

The rows are the ones the tensor path gives the kernel: the script runs
``chip_smoke.py``'s tensor path once, recording every K2 call's rows and
head share (the rows it evaluates: ``chip_smoke._k2_heads``) through
``_EdgeTap`` (which wraps the wrapper here, not in the package), prints
their spread, runs the path again to capture the inputs of its largest
call and of its median one, and builds ``chip_smoke.py``'s own [kernel]
K2 row from the output (the unique-edge table of the output mesh).  The
verdict line of each row says whether the committed kernel is at or
below ``prev`` in every turn, warm and cold; the script exits 1 unless
it is on every row.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k2_variants.py
"""
from __future__ import annotations

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import k3_k4_variants as k34  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "parmmg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k2_variants")
SYM = "pm_edge_lengths_ani"

# the previous csrc/edge_length_ani.cu, as it was
PREV = r"""// Anisotropic metric edge length, one thread per unique edge.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:edge_length_ani_pallas
// (_len_ani_kernel): per edge e = p1 - p0, the endpoint quadratic forms
// q_i = e^T M_i e of the packed tensors (m11, m12, m13, m22, m23, m33),
// l_i = sqrt(max(q_i, 0)) and l = 2/3 (l0^2 + l0 l1 + l1^2) / max(l0 + l1,
// EPSD).  The TPU version left the endpoint gathers and the index clip of
// ops/edges.py:edge_lengths to XLA, which wrote [capE, 3] and [capE, 6]
// endpoint rows to memory before the kernel read them back; here they are
// folded in, so the edge table's (a, b) ids are read once and no endpoint
// row reaches device memory.
//
// Bound on the card: bytes.  Per edge it reads 8 bytes of ids and writes 4;
// the endpoint rows (12 bytes of point, 24 of tensor) are random gathers
// that mostly hit L2 (vert + met6 of a 50k-point mesh take 1.8 MB), so they
// are counted once per point.  Least time = (12 * capE + 36 * capP) bytes /
// 3.35 TB/s.  Design: a plain grid-stride loop, one thread per edge, no
// shared memory; the arithmetic (two quadratic forms, two sqrt, one divide,
// ~40 flops) is far below the memory time.  nvcc contracts the multiply-adds
// into FMAs and the form is summed in the Pallas kernel's order, not
// einsum's, so results agree with the plain version to a few ulp.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsd = 1e-30f;

__device__ __forceinline__ float quad(const float* __restrict__ m, float x,
                                      float y, float z) {
  return m[0] * x * x + m[3] * y * y + m[5] * z * z +
         2.0f * (m[1] * x * y + m[2] * x * z + m[4] * y * z);
}

__global__ void edge_length_ani_kernel(const float* __restrict__ vert,
                                       const float* __restrict__ met6,
                                       const int* __restrict__ ev,
                                       float* __restrict__ out, int capP,
                                       long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int i0 = min(max(ev[2 * i], 0), capP - 1);
    const int i1 = min(max(ev[2 * i + 1], 0), capP - 1);
    const float x = vert[3 * i1] - vert[3 * i0];
    const float y = vert[3 * i1 + 1] - vert[3 * i0 + 1];
    const float z = vert[3 * i1 + 2] - vert[3 * i0 + 2];
    const float l0 = sqrtf(fmaxf(quad(met6 + 6 * (long long)i0, x, y, z),
                                 0.0f));
    const float l1 = sqrtf(fmaxf(quad(met6 + 6 * (long long)i1, x, y, z),
                                 0.0f));
    const float s = fmaxf(l0 + l1, kEpsd);
    out[i] = (2.0f / 3.0f) * (l0 * l0 + l0 * l1 + l1 * l1) / s;
  }
}

}  // namespace

extern "C" int pm_edge_lengths_ani(const float* vert, const float* met6,
                                   const int* ev, float* out, int capP,
                                   long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  edge_length_ani_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(vert, met6, ev, out, capP,
                                                   n);
  return (int)cudaGetLastError();
}
"""

_FLAGS = {"noreuse": "kReuse", "nocross": "kCrossLane", "lanes": "kCompact",
          "noldg": "kLdg", "metsc": "kMetVec"}
_GRID = "  const long long blocks = (nchunks + kWarps - 1) / kWarps;\n"
_GRID_SM = """\
  long long blocks = (nchunks + kWarps - 1) / kWarps;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > (long long)sms * {cap}) blocks = (long long)sms * {cap};
"""
_LOADS0 = "// point row i: three floats"
_LOADS1 = "// end of the endpoint loads\n"
_WIDE = """\
// point row i: a float2 and a float, split by i's parity (three floats
// where vert is not 8-byte aligned)
__device__ __forceinline__ void point(const float* __restrict__ vert, int i,
                                      float* p) {
  const float* q = vert + 3 * (long long)i;
  if ((uintptr_t)vert % 8 == 0) {
    const bool odd = i & 1;
    const float2 h = gather(reinterpret_cast<const float2*>(q + odd));
    const float f = gather(q + (odd ? 0 : 2));
    p[0] = odd ? f : h.x;
    p[1] = odd ? h.x : h.y;
    p[2] = odd ? h.y : f;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = gather(q + k);
  }
}

// tensor row i: a float4 and a float2, split by i's parity, where met6 is
// 16-byte aligned, else three float2 (vec) or six floats
__device__ __forceinline__ void tensor(const float* __restrict__ met6,
                                       int i, bool vec, float* m) {
  const float* p = met6 + 6 * (long long)i;
  if (vec && (uintptr_t)met6 % 16 == 0) {
    const bool odd = i & 1;
    const float4 f = gather(reinterpret_cast<const float4*>(p + 2 * odd));
    const float2 h = gather(reinterpret_cast<const float2*>(p + (odd ? 0
                                                                  : 4)));
    m[0] = odd ? h.x : f.x; m[1] = odd ? h.y : f.y;
    m[2] = odd ? f.x : f.z; m[3] = odd ? f.y : f.w;
    m[4] = odd ? f.z : h.x; m[5] = odd ? f.w : h.y;
  } else if (vec) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 a = gather(q), b = gather(q + 1), c = gather(q + 2);
    m[0] = a.x; m[1] = a.y; m[2] = b.x; m[3] = b.y; m[4] = c.x; m[5] = c.y;
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) m[k] = gather(p + k);
  }
}
"""
_STREAM = (("__ldg(p + h)", "__ldcs(p + h)"),
           ("__ldg(ev + 2 * (r0 + s))", "__ldcs(ev + 2 * (r0 + s))"),
           ("__ldg(ev + 2 * (r0 + s) + 1)", "__ldcs(ev + 2 * (r0 + s) + 1)"),
           ("""\
          *reinterpret_cast<float4*>(out + r0) =
              make_float4(g[0], g[1], g[2], g[3]);""", """\
          __stcs(reinterpret_cast<float4*>(out + r0),
                 make_float4(g[0], g[1], g[2], g[3]));"""),
           ("*reinterpret_cast<float2*>(out + r0) = make_float2(g[0], g[1]);",
            "__stcs(reinterpret_cast<float2*>(out + r0), "
            "make_float2(g[0], g[1]));"),
           ("out[r0 + s] = g[s];", "__stcs(out + r0 + s, g[s]);"))


def _flag(src: str, name: str) -> str:
    """``src`` with the constexpr bool ``name`` the other way round."""
    m = re.search(rf"constexpr bool {name} = (true|false);", src)
    if not m:
        raise RuntimeError(f"the source's {name} line moved")
    flip = "false" if m.group(1) == "true" else "true"
    return k34._patch(src, (m.group(0), f"constexpr bool {name} = {flip};"))


def variants():
    """(the committed variant's name, {variant: CUDA source})."""
    with open(os.path.join(CSRC, "edge_length_ani.cu")) as f:
        src = f.read()
    rows = re.search(r"constexpr int kRows = (\d+);", src)
    if not rows:
        raise RuntimeError("the source's kRows line moved")
    out = {"prev": PREV}
    for r in (2, 4, 8):
        out[f"r{r}"] = k34._patch(src, (rows.group(0),
                                        f"constexpr int kRows = {r};"))
    for name, flag in _FLAGS.items():
        out[name] = _flag(src, flag)
    for c in (6, 12, 16):
        out[f"cap{c}"] = k34._patch(src, (_GRID, _GRID_SM.format(cap=c)))
    i, j = src.index(_LOADS0), src.index(_LOADS1)
    out["wide"] = src[:i] + _WIDE + src[j:]
    out["stream"] = k34._patch(src, *_STREAM)
    return f"r{rows.group(1)}", out


def use(lib) -> None:
    """Point the port's K2 wrapper at the library ``lib`` (every variant,
    ``prev`` included, has the same C signature)."""
    from parmmg_tpu_torch.ops import kernels as K
    K._FNS[SYM] = k34._bind(lib, SYM, K._SIGS[SYM][1])


class _EdgeTap:
    """Stands in for ``kernels.edge_lengths_ani`` (K2) over a run: records
    every call as (rows, heads), the heads (``chip_smoke._k2_heads``) kept
    as a 0-d tensor and read only after the run, and clones the inputs of
    the calls whose indices are in ``capture``."""

    def __init__(self, capture=()):
        self.capture = set(capture)
        self.calls, self.inputs = [], {}

    def __enter__(self):
        import chip_smoke as cs
        from parmmg_tpu_torch.ops import kernels
        self._real = kernels.edge_lengths_ani

        def call(vert, met6, ev, _fn=self._real):
            if len(self.calls) in self.capture:
                self.inputs[len(self.calls)] = tuple(
                    t.clone() for t in (vert, met6, ev))
            self.calls.append((ev.shape[0], cs._k2_heads(ev, vert.shape[0])))
            return _fn(vert, met6, ev)
        kernels.edge_lengths_ani = call
        return self

    def __exit__(self, *exc):
        from parmmg_tpu_torch.ops import kernels
        kernels.edge_lengths_ani = self._real

    def counts(self):
        """[(rows, heads)] of every call, in call order."""
        return [(n, int(h)) for n, h in self.calls]


def path_rows():
    """{label: (vert, met6, ev)}: chip_smoke.py's [kernel] K2 input on the
    tensor path's output, and the path's largest and median K2 calls."""
    import numpy as np
    import chip_smoke as cs
    from parmmg_tpu_torch.ops.edges import unique_edges
    wd = os.path.join(OUT, "smoke")
    os.makedirs(wd, exist_ok=True)
    stem = "cube16ani"
    with _EdgeTap() as tap:
        _, shapes = cs.phase_path(wd, stem)
    calls = tap.counts()
    n = np.array([c[0] for c in calls])
    share = np.array([c[1] for c in calls]) / np.maximum(n, 1)
    order = sorted(range(len(calls)), key=lambda i: (calls[i][0], i))
    picks = {"largest": order[-1], "median": order[len(order) // 2]}
    print(f"[rows] {stem} K2 calls {len(calls)}: rows median "
          f"{int(np.median(n))} max {int(n.max())}; head share median "
          f"{float(np.median(share)):.4f} min {float(share.min()):.4f} max "
          f"{float(share.max()):.4f}")
    with _EdgeTap(picks.values()) as tap:
        cs._run_main(wd, stem, os.path.join(wd, f"{stem}.r2.mesh"))
    if tap.counts() != calls:
        raise RuntimeError("a rerun of the path made other K2 calls than "
                           "the first run")
    mesh, met6, _ = cs._read_output(os.path.join(wd, f"{stem}.o.mesh"),
                                    capP=shapes["capP"], capT=shapes["capT"])
    ev = unique_edges(mesh, shell_slots=0).ev.contiguous()
    rows = {"fixture": (mesh.vert, met6, ev)}
    for pick, i in picks.items():
        rows[f"{pick} call of {stem}"] = tap.inputs[i]
    out = {}
    for label, args in rows.items():
        nr, heads = args[2].shape[0], int(cs._k2_heads(args[2],
                                                       args[0].shape[0]))
        out[f"{label} [{nr} rows, {heads / max(nr, 1):.4f} heads]"] = args
    return out


def references(cases):
    """{label: (prev's output, the plain version's)}; ``prev`` must be in
    use."""
    from parmmg_tpu_torch.ops import kernels as K
    return {label: (K.edge_lengths_ani(*args),
                    K.edge_lengths_ani_plain(*args))
            for label, args in cases.items()}


def check(cases, refs, is_prev=False) -> str:
    """'' when the K2 in use holds on every case (see the module's
    docstring), else the first case that differs."""
    import torch
    from parmmg_tpu_torch.ops import kernels as K
    for label, args in cases.items():
        got = K.edge_lengths_ani(*args)
        prev, plain = refs[label]
        fixed = torch.isnan(plain) & ~torch.isnan(prev)
        bits = got.view(torch.int32).masked_fill(fixed, 0)
        if not torch.equal(bits, prev.view(torch.int32).masked_fill(fixed, 0)):
            return f"{label}: bits"
        if is_prev:
            got, plain = got[~fixed], plain[~fixed]
        if not torch.allclose(got, plain, rtol=3e-5, atol=3e-6,
                              equal_nan=True):
            return f"{label}: plain"
    return ""


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
    libs = k34.build(srcs, OUT)
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s; the committed source is {new}")
    if "prev" not in libs or new not in libs:
        return 1
    rows = path_rows()
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cases = dict(rows)
    for n in cs.K2_SIZES:
        for label, *args in cs._k2_cases(n, gen, dev):
            cases[f"n={n} {label}"] = tuple(args)
    use(libs["prev"])
    refs = references(cases)
    fns = {}
    for name, lib in libs.items():
        try:
            use(lib)
            bad = check(cases, refs, is_prev=name == "prev")
        except Exception as ex:          # a variant that faults is dropped
            bad = repr(ex)
        print(f"[check] {name}: "
              + (f"DIFFERS: {bad}" if bad else
                 f"holds on every case ({len(cases)})"))
        if bad and name in (new, "prev"):
            print(f"[verdict] {name} is wrong")
            return 1
        if not bad:
            fns[name] = lib
    del refs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stream = torch.cuda.Stream(device=dev)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    res: dict = {}
    for turn in range(2):
        for label, args in rows.items():
            names = list(fns) if turn == 0 else list(fns)[::-1]
            for name in names:
                use(fns[name])

                def fn(args=args):
                    return K.edge_lengths_ani(*args)
                warm = k34.batch_ms(fn, stream)
                cold = k34.batch_ms(fn, stream, flush)
                res.setdefault((label, name), []).append((warm, cold))
                print(f"[turn {turn + 1}] {label:52s} {name:7s} graph ms "
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
