"""Time K7 (``csrc/radix_sort.cu``) against variants of its own source.

Each variant is the committed source with a few lines replaced:

  tree    the source as it is (look-back over a Fenwick tree of tiles)
  walk    the look-back it replaced: a tile publishes its digit counts at
          once; one warp finds the nearest tile whose prefix is out, 32
          tiles a round trip, and each digit walks back to it, 8 loads in
          flight, then publishes its inclusive prefix
  fenw8   the tree with 8 look-back loads in flight instead of 4
  t1024   the tree with 1,024-thread tiles (10,240 keys, one block an SM)
  pdl     the tree with programmatic dependent launch between its kernels
  gather  the tree gathering every pass's key by position instead of
          carrying a word's key in sorted order between its passes
  i8      8 keys a thread (4,096-key tiles) instead of 10
  i16     16 keys a thread (8,192-key tiles)
  t256    256-thread tiles (2,560 keys)
  match   ranking by __match_any_sync instead of eight ballots

Every variant is built with the port's nvcc flags (one ``nvcc`` each, all
started together), checked exactly against ``radix_sort_plain`` (the main
path's two key sets, 2**24 + 3 full-range keys, and ``chip_smoke``'s stress
phase), then timed in turns, the variants in order and then in reverse, on
the main path's key shapes made from a seed: the edge keys (1,325,952 rows,
1 word, 4 passes) and the face keys (883,968 rows, nbits (16, 32), 6
passes).  A reading is the median over 5 batches of 50 back-to-back calls
between two CUDA events (device throughput: the host is ahead), and the
profiler's time of K7's kernels per call.  A variant counts as faster or
slower than the tree only where it is so by 3% in every turn on both key
sets.  It also prints what the wrapper's stream lookup costs on the host.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k7_variants.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "parmmg_tpu_torch", "csrc", "radix_sort.cu")
OUT = os.path.join(ROOT, "build", "k7_variants")

_WALK_CONSTS = """\
constexpr u64 FLAG_AGG = 1ull << 32;    // the tile's count of the digit
constexpr u64 FLAG_PREFIX = 2ull << 32; // the count over tiles 0..tile
constexpr int LB = 8;                   // walk loads in flight

__device__ __forceinline__ u64 wait_status(const u64* p) {
  u64 s;
  do {
    s = pm_scan::ld_status(p);
  } while (!(s >> 32));
  return s;
}
"""
_TREE_PUBLISH = """\
    const unsigned range =
        count + fenwick_sum(status, t, m - 1, m - (m & (0u - m)));
    pm_scan::st_status(&status[(long long)tile * RADIX + t],
                       FLAG_OUT | range);
"""
_WALK_PUBLISH = """\
    pm_scan::st_status(&status[(long long)tile * RADIX + t],
                       (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | count);
"""
_TREE_PREFIX = """\
  if (t < RADIX) {
    // the digit's count over tiles 0 .. tile - 1: the Fenwick prefix
    const unsigned excl = fenwick_sum(status, t, m - 1, 0u);
"""
_WALK_PREFIX = """\
  unsigned* s_lo = s_tile + 1;
  if (wid == 0 && tile > 0) {
    long long win = (long long)tile - 1;
    while (true) {
      const long long p = win - lane;
      u64 s = FLAG_PREFIX;
      if (p >= 0) s = wait_status(&status[p * RADIX]);
      const unsigned pre =
          __ballot_sync(pm_scan::FULL, (s & ~0xffffffffull) == FLAG_PREFIX);
      if (pre) {
        if (lane == 0) *s_lo = (unsigned)(win - (__ffs(pre) - 1));
        break;
      }
      win -= 32;
    }
  }
  __syncthreads();
  if (t < RADIX) {
    unsigned excl = 0;
    if (tile > 0) {
      const long long lo = *s_lo;
      bool done = false;
      for (long long q = (long long)tile - 1; !done; q -= LB) {
        u64 w[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u)
          w[u] = q - u >= lo ? pm_scan::ld_status(&status[(q - u) * RADIX + t])
                             : 0ull;
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          if (done || q - u < lo) continue;
          u64 s = w[u];
          while ((s & ~0xffffffffull) != FLAG_PREFIX &&
                 (q - u == lo || !(s >> 32)))
            s = pm_scan::ld_status(&status[(q - u) * RADIX + t]);
          excl += (unsigned)s;
          done = (s & ~0xffffffffull) == FLAG_PREFIX;
        }
      }
      pm_scan::st_status(&status[(long long)tile * RADIX + t],
                         FLAG_PREFIX | (excl + count));
    }
"""
_FENW = "constexpr int FENW = 4;                 // look-back loads in flight\n"
_LAUNCH = """\
      radix_pass_kernel<<<(unsigned)tiles, SORT_THREADS, SORT_SMEM, s>>>(
          words[j], bits[j], shift, in, kin, dst, kdst, gbase + k * RADIX,
          st[k & 1], k + 1 < npass ? st[(k + 1) & 1] : nullptr, ctrl, n);
"""
_PDL_LAUNCH = """\
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)tiles);
      cfg.blockDim = dim3(SORT_THREADS);
      cfg.dynamicSmemBytes = SORT_SMEM;
      cfg.stream = s;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      at[0].val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      u64* nxt = k + 1 < npass ? st[(k + 1) & 1] : nullptr;
      const unsigned* gb = gbase + k * RADIX;
      e = cudaLaunchKernelEx(&cfg, radix_pass_kernel, words[j], bits[j],
                             shift, in, kin, dst, kdst, gb, st[k & 1], nxt,
                             ctrl, n);
      if (e != cudaSuccess) return (int)e;
"""
_PASS_ZERO = ("  for (int i = t; i < SORT_WARPS * RADIX; i += SORT_THREADS) "
              "cnt[i] = 0;\n")
_PDL_WAIT = ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
             '  asm volatile("griddepcontrol.launch_dependents;" ::: '
             '"memory");\n')
_HIST_START = ("  const long long stride = (long long)gridDim.x * "
               "HIST_THREADS;\n")
_PDL_TRIGGER = ('  asm volatile("griddepcontrol.launch_dependents;" ::: '
                '"memory");\n')
_ITEMS = "constexpr int SORT_ITEMS = 10;"
_BALLOTS = """\
    unsigned peers = __ballot_sync(pm_scan::FULL, ok);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned set = __ballot_sync(pm_scan::FULL, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? set : ~set;
    }
"""
# lanes past the end form a group of their own (value 256)
_MATCH = """\
    const unsigned peers = __match_any_sync(pm_scan::FULL, ok ? d : 256u);
"""


def _patch(text: str, *pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"radix_sort.cu no longer holds, once:\n{old}")
        text = text.replace(old, new)
    return text


def variants() -> dict:
    """Variant name -> CUDA source."""
    with open(SRC) as f:
        tree = f.read()
    return {
        "tree": tree,
        "walk": _patch(tree, (_FENW, _FENW + _WALK_CONSTS),
                       ("SORT_WARPS + 2);", "SORT_WARPS + 3);"),
                       (_TREE_PUBLISH, _WALK_PUBLISH),
                       (_TREE_PREFIX, _WALK_PREFIX)),
        "fenw8": _patch(tree, (_FENW, _FENW.replace("4;", "8;"))),
        "t1024": _patch(tree, ("constexpr int SORT_THREADS = 512;",
                               "constexpr int SORT_THREADS = 1024;"),
                        ("__launch_bounds__(SORT_THREADS, 2)",
                         "__launch_bounds__(SORT_THREADS, 1)")),
        "pdl": _patch(tree, (_PASS_ZERO, _PASS_ZERO + _PDL_WAIT),
                      (_HIST_START, _HIST_START + _PDL_TRIGGER),
                      (_LAUNCH, _PDL_LAUNCH)),
        "gather": _patch(tree, ("(keys_a && shift + 8 < bits[j])",
                                "(keys_a && false)")),
        "i8": _patch(tree, (_ITEMS, _ITEMS.replace("10", "8"))),
        "i16": _patch(tree, (_ITEMS, _ITEMS.replace("10", "16"))),
        "t256": _patch(tree, ("constexpr int SORT_THREADS = 512;",
                              "constexpr int SORT_THREADS = 256;")),
        "match": _patch(tree, (_BALLOTS, _MATCH)),
    }


def build(srcs: dict) -> dict:
    """Variant name -> path of its library; a variant that fails to build
    is printed and left out."""
    from parmmg_tpu_torch.ops import cuda_build
    procs = {}
    for name, text in srcs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "radix_sort.cu"), "w") as f:
            f.write(text)
        procs[name] = (os.path.join(d, "lib.so"), subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
             f"-I{cuda_build.CSRC}", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "radix_sort.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"[build] {name}: nvcc exit {p.returncode}\n{out[-3000:]}")
        else:
            libs[name] = lib
    return libs


def use(lib: str) -> None:
    """Point the port's K7 wrapper at the library ``lib``."""
    from parmmg_tpu_torch.ops import kernels as K
    so = ctypes.CDLL(lib)
    f = so.pm_radix_sort
    f.argtypes = K._SIGS["pm_radix_sort"][1]
    f.restype = ctypes.c_int
    K._FNS["pm_radix_sort"] = f
    K._TILES["pm_radix_tile"] = int(so.pm_radix_tile())


def batch_ms(fn, reps: int = 50, batches: int = 5) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    ts.sort()
    return ts[len(ts) // 2]


def stream_lookup_us(dev, reps: int = 100000) -> dict:
    """Host microseconds a call of the public and the private lookup of
    the current stream's handle."""
    import torch
    ways = {"torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
            "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index)}
    res = {}
    for name, fn in list(ways.items()) * 2:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res[name] = min(res.get(name, 1e9),
                        (time.perf_counter() - t0) / reps * 1e6)
    return res


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
    libs = build(variants())
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def keys(lo, hi, n, dead):
        k = torch.randint(lo, hi, (n,), device=dev, dtype=torch.int32,
                          generator=g)
        k[torch.rand(n, device=dev, generator=g) < dead] = 2 ** 31 - 1
        return k
    capP = 42364                        # the iso path's, chip_smoke.py
    cases = {"edge": ((keys(0, capP * capP, 1325952, 0.5),), None),
             "face": ((keys(0, capP, 883968, 0.5),
                       keys(0, capP * capP, 883968, 0.0)), (16, 32))}
    big = torch.randint(-2 ** 31, 2 ** 31, (2 ** 24 + 3,), device=dev,
                        dtype=torch.int64, generator=g).to(torch.int32)
    refs = {c: K.radix_sort_plain(*a) for c, a in cases.items()}
    ref_big = K.radix_sort_plain((big,))
    ok = []
    for name, lib in libs.items():
        use(lib)
        try:
            good = all(torch.equal(K.radix_sort(*a), refs[c])
                       for _ in range(3) for c, a in cases.items())
            good = good and torch.equal(K.radix_sort((big,)), ref_big)
            if good:
                cs.phase_stress(repeats=2)
        except Exception as ex:         # a variant that faults is dropped
            print(f"[check] {name}: {ex}")
            good = False
        print(f"[check] {name} {'equal' if good else 'WRONG'}", flush=True)
        if good:
            ok.append(name)
    if "tree" not in ok:
        print("the committed source failed its check", file=sys.stderr)
        return 1
    res: dict = {}
    for turn, order in enumerate((ok, ok[::-1])):
        for name in order:
            use(libs[name])
            for c, a in cases.items():
                bm = batch_ms(lambda: K.radix_sort(*a))
                dms, nl = cs._device_ms(lambda: K.radix_sort(*a), "radix_")
                res.setdefault((name, c), []).append(bm)
                print(f"[turn {turn + 1}] {name:6s} {c} keys: batch ms "
                      f"{bm:.4f}, profiler device ms {dms}, launches "
                      f"{nl:g} a call", flush=True)
    for name in ok:
        if name == "tree":
            continue
        parts, faster, slower = [], True, True
        for c in cases:
            v, t = res[(name, c)], res[("tree", c)]
            faster = faster and max(v) <= 0.97 * min(t)
            slower = slower and max(t) <= 0.97 * min(v)
            parts.append(f"{c} {min(v) / min(t):.3f}-{max(v) / max(t):.3f}")
        verdict = ("faster by 3% in every turn" if faster else
                   "slower by 3% in every turn" if slower else
                   "within 3% in some turn")
        print(f"[verdict] {name} / tree batch ms (best, worst turn): "
              f"{', '.join(parts)}: {verdict}")
    # the library call: torch.sort of the edge keys, and of the face keys
    # packed into one int64 (remapped f0 << 32 | fw as uint32)
    f0, fw = cases["face"][0]
    packed = ((torch.where(f0 == 2 ** 31 - 1, 0xFFFF, f0).long() << 32)
              | (fw.long() & 0xFFFFFFFF))
    for c, k in (("edge", cases["edge"][0][0]), ("face", packed)):
        print(f"[library] torch.sort(stable=True) {c} keys: batch ms "
              f"{batch_ms(lambda: torch.sort(k, stable=True)):.4f}")
    for name, us in stream_lookup_us(dev).items():
        print(f"[host] {name}: {us:.3f} us a call")
    print(cs._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
