"""Workers of ``tests/test_torch_parallel.py``: the data-parallel cases run
by each of two gloo processes, and the one-process references.

Kept out of the test file: ``spawn`` re-imports the module that defines a
worker, and this one imports neither JAX nor a test file.
"""

import datetime
import os

import numpy as np
import torch

SIZE, BATCH, WORLD = 32, 4, 2
CYCLEGAN = dict(gen_type="p2p-content", in_features=4, n_residual_blocks=1,
                image_size=SIZE, batch_size=BATCH, pool_size=2,
                compute_dtype=torch.float32, device="cpu")
P2P = {"global": dict(net_g="global", ngf=4, n_downsample_global=2,
                      n_blocks_global=1, ndf=8, num_d=2, n_layers_d=2,
                      image_size=SIZE, compute_dtype=torch.float32,
                      device="cpu", pool_size=2),
       "multiscale": dict(net_g="multiscale", ngf=4, n_blocks_global=1,
                          ndf=8, num_d=2, n_layers_d=2, image_size=SIZE,
                          compute_dtype=torch.float32, device="cpu")}
# min_points: met (the step runs) and not met (the skip gate holds it)
GATES = {"on": 0.0, "off": 1e9}
STEPS = 2
INFER = dict(gen_type="p2p-content", in_features=8, n_residual_blocks=2,
             compute_dtype=torch.float32, device="cpu")


def batches(seed, n, channels=1):
    """``n`` global batches of sparse [-1, 1] frames, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(np.where(rng.rand(BATCH, SIZE, SIZE, channels)
                                      > 0.9, 1.0, -1.0).astype(np.float32))
            for _ in range(n)]


def _moments(*opts):
    return [o.mu_flat.clone() for o in opts if o is not None]


def cyclegan_run(min_points, mesh=None):
    """``STEPS`` CycleGAN steps on the global batches (this rank's slice
    under ``mesh``): per step the metrics and the three Adam first
    moments, and the pools at the end."""
    from cistar_tpu_torch.engines.cyclegan import CycleGAN
    from cistar_tpu_torch.parallel.sharding import shard_batch

    eng = CycleGAN(min_points=min_points, mesh=mesh, **CYCLEGAN)
    st = eng.init_state(0)
    out = []
    for a, b in zip(batches(1, STEPS), batches(2, STEPS)):
        if mesh is not None:
            a, b = shard_batch((a, b), mesh)
        st, m = eng.train_step(st, a, b)
        out.append(({k: float(v) for k, v in m.items()},
                    _moments(st.opt_g, st.opt_d_a, st.opt_d_b)))
    return out, [st.pool_a.images.clone(), st.pool_b.images.clone(),
                 int(st.pool_a.size), int(st.pool_b.size)]


def p2phd_run(net, mesh=None):
    """``STEPS`` pix2pixHD steps: per step the metrics, the Adam first
    moments of G and D, and G's BatchNorm running statistics."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.parallel.sharding import shard_batch

    eng = Pix2PixHD(mesh=mesh, **P2P[net])
    st = eng.init_state(0)
    out = []
    for label, image in zip(batches(3, STEPS), batches(4, STEPS)):
        if mesh is not None:
            label, image = shard_batch((label, image), mesh)
        st, m, _ = eng.train_step(st, label, None, image)
        stats = [b.clone() for b in eng.G.buffers()]
        out.append(({k: float(v) for k, v in m.items()},
                    _moments(st.opt_g, st.opt_d), stats))
    return out


def infer_engine():
    from cistar_tpu_torch.engines.cyclegan import CycleGANInference
    return CycleGANInference(**INFER)


def worker(rank, tmp):
    """Rank ``rank`` of ``WORLD`` gloo processes: every case, its results
    to ``tmp/rank<rank>.pt``."""
    torch.set_num_threads(1)
    from cistar_tpu_torch.engines.cyclegan import InferProgram
    from cistar_tpu_torch.parallel import sharding
    from cistar_tpu_torch.runtime.aot import load_compiled, save_compiled

    mesh = sharding.make_mesh(
        "cpu", rank, WORLD, "file://" + os.path.join(tmp, "rendezvous"),
        timeout=datetime.timedelta(seconds=120))
    try:
        res = {"cyclegan": {g: cyclegan_run(mp, mesh)
                            for g, mp in GATES.items()},
               "p2phd": {net: p2phd_run(net, mesh) for net in P2P}}
        eng = infer_engine()
        a, b = batches(5, 1)[0], batches(6, 1)[0]
        for kind in ("bf16", "int8"):
            extra = eng.program_args(kind)
            path = os.path.join(tmp, f"{kind}.pt2")
            if rank == 0:
                with torch.no_grad():
                    save_compiled(InferProgram(eng, kind == "int8"),
                                  extra + sharding.shard_batch((a, b), mesh),
                                  path)
            torch.distributed.barrier()
            res[kind] = [
                eng.make_sharded_infer(mesh, kind, prog)(*extra, a, b)
                for prog in (None, load_compiled(path))]
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        sharding.close_mesh(mesh)
