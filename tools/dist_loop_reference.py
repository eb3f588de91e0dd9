#!/usr/bin/env python3
"""Set the port's two-pass distributed loop beside the JAX package's on
the CPU, and print one JSON line a run.

    JAX_PLATFORMS=cpu python tools/dist_loop_reference.py [--graph N]

Without arguments: ``distributed_adapt_multi(niter=2, cycles=2)`` on
cube_mesh(3) at 4x capacity under the shock size map h = 0.3 (the input
of ``tests/test_torch_migrate.py``) on 2 and 4 shards, the port's on the
CPU against the JAX package's compiled loop with ``n_devices=1`` (G = the
shard count, as the port stacks them), then both packages'
``steady_state_migration_scenario()``.  Each line gives, for both: the op
counts (cycles, splits, collapses, swaps, moves; the scenario's are not
returned), live tets, live vertices, the vertices the live tets reference
(the JAX package's ``device_migrate`` keeps rows live that only another
shard's tets use, ROADMAP C2), and the iso shape quality's min and mean.

With ``--graph N``: ``ParMesh`` at 4 shards and ``-niter 2`` in graph mode
(``repartitioningMode = REPART_GRAPH``) on cube_mesh(N) under the cube16
shock map (h = 1.5/16), from the decomposition ``end_slabs_partition``
(as a distributed input hands it to the run), through both packages on
one device (the 4 shards stacked, as the port runs them); the line gives
the tet count and the min and mean of the same quality.  A few minutes a
run.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quality(vert, tet):
    """Mmg's iso shape quality of every tet, from host arrays."""
    import numpy as np
    p = vert[tet]
    e = [p[:, i] - p[:, j] for i, j in ((1, 0), (2, 0), (3, 0), (2, 1),
                                        (3, 1), (3, 2))]
    vol = np.einsum("ti,ti->t", e[0], np.cross(e[1], e[2])) / 6.0
    l2 = sum((x * x).sum(axis=1) for x in e)
    return 6.0 * np.sqrt(2.0) * 6.0 ** 1.5 * vol / np.maximum(l2, 1e-30) \
        ** 1.5


def _summary(mesh_fields):
    """(live tets, live vertices, referenced vertices, qmin, qmean) of a
    mesh given as numpy fields."""
    import numpy as np
    tm, vm = mesh_fields["tmask"], mesh_fields["vmask"]
    tet = mesh_fields["tet"][tm]
    ref = np.zeros(len(vm), bool)
    ref[tet.reshape(-1)] = True
    q = _quality(mesh_fields["vert"].astype(np.float64), tet)
    return dict(tets=int(tm.sum()), verts=int(vm.sum()),
                referenced=int(ref.sum()), qmin=float(q.min()),
                qmean=float(q.mean()))


def _fields(mesh):
    import numpy as np
    return {k: np.asarray(getattr(mesh, k).cpu() if hasattr(
        getattr(mesh, k), "cpu") else getattr(mesh, k))
        for k in ("vert", "tet", "tmask", "vmask")}


def loops():
    import numpy as np
    import jax.numpy as jnp
    import torch
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu.ops.adapt import AdaptStats as JStats
    from parmmg_tpu.parallel import dist as JDi
    from parmmg_tpu.utils.fixtures import \
        steady_state_migration_scenario as jscenario
    from parmmg_tpu_torch.core import mesh as tmesh
    from parmmg_tpu_torch.ops.adapt import AdaptStats
    from parmmg_tpu_torch.ops.analysis import analyze_mesh
    from parmmg_tpu_torch.parallel import dist as TDi
    from parmmg_tpu_torch.utils.fixtures import (analytic_iso_metric,
                                                 cube_mesh)
    from parmmg_tpu_torch.utils.fixtures import \
        steady_state_migration_scenario as tscenario
    torch.set_num_threads(1)
    v, t = cube_mesh(3)
    m = analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                     capT=4 * len(t))).mesh
    h = np.ones(m.capP, np.float32)
    h[: len(v)] = analytic_iso_metric(v, "shock", h=0.3)
    met = torch.from_numpy(h)
    jm = jmesh.Mesh(**{k: jnp.asarray(a) for k, a in
                       tmesh.mesh_to_numpy(m).items()})

    def ops(st):
        return [st.cycles, st.nsplit, st.ncollapse, st.nswap, st.nmoved]
    for n in (2, 4):
        st, jst = AdaptStats(), JStats()
        port = TDi.distributed_adapt_multi(m, met, n, niter=2, cycles=2,
                                           stats=st)
        jax_ = JDi.distributed_adapt_multi(jm, jnp.asarray(h), n, niter=2,
                                           cycles=2, n_devices=1, stats=jst)
        print(json.dumps({"run": f"loop {n} shards",
                          "port": dict(ops=ops(st),
                                       **_summary(_fields(port[0]))),
                          "jax": dict(ops=ops(jst),
                                      **_summary(_fields(jax_[0])))}),
              flush=True)
    port = tscenario(device="cpu", return_all=True)
    jax_ = jscenario(n_devices=1, return_all=True)
    print(json.dumps({"run": "steady_state_migration_scenario",
                      "port": _summary(_fields(port[0])),
                      "jax": _summary(_fields(jax_[0]))}), flush=True)


def graph(n: int):
    import numpy as np
    from parmmg_tpu_torch.utils.fixtures import (analytic_iso_metric,
                                                 cube_mesh,
                                                 end_slabs_partition)
    v, t = cube_mesh(n)
    met = analytic_iso_metric(v, "shock", h=1.5 / 16)
    part = end_slabs_partition(v, t)
    out = {"run": f"graph mode cube_mesh({n}) 4 shards -niter 2"}
    for which in ("port", "jax"):
        if which == "jax":
            import functools
            from parmmg_tpu.api import IParam, ParMesh
            from parmmg_tpu.core import constants as C
            from parmmg_tpu.parallel import dist as jdist
            # the 4 shards stacked on the one device, as the port runs them
            jdist.distributed_adapt_multi = functools.partial(
                jdist.distributed_adapt_multi, n_devices=1)
            pm = ParMesh()
        else:
            from parmmg_tpu_torch.api.parmesh import ParMesh
            from parmmg_tpu_torch.api.params import IParam
            from parmmg_tpu_torch.core import constants as C
            pm = ParMesh(device="cpu")
        pm.set_mesh_size(np_=len(v), ne=len(t))
        pm.set_vertices(v)
        pm.set_tetrahedra(t + 1)
        pm.set_met_size(1, len(v))
        pm.set_scalar_mets(met)
        pm.set_iparameter(IParam.niter, 2)
        pm.set_iparameter(IParam.repartitioningMode, C.REPART_GRAPH)
        pm.info.n_devices = 4
        pm.info.imprim = 0
        pm._in_part = part       # what a distributed input's loader sets
        pm.run()
        vv, _ = pm.get_vertices()
        tt, _ = pm.get_tetrahedra()
        q = _quality(np.asarray(vv, np.float64), np.asarray(tt) - 1)
        out[which] = dict(tets=len(tt), qmin=float(q.min()),
                          qmean=float(q.mean()))
    print(json.dumps(out), flush=True)


def main(argv):
    os.environ.setdefault("PARMMG_SWAP_FACESORT", "1")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_parity
    torch_parity.wrap_ledger_listener()
    if argv[:1] == ["--graph"]:
        graph(int(argv[1]))
    else:
        loops()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
