"""Workers of ``tests/test_torch_uda_dp.py``: the data-parallel UDA steps
and CLI runs of each of two gloo processes, and the one-process
references.

Kept out of the test file: ``spawn`` re-imports the module that defines a
worker, and this one imports neither JAX nor a test file.
"""

import datetime
import os

import numpy as np
import torch

WORLD, SIZE, BATCH, STEPS = 2, 64, 4, 2
UDA = dict(size=SIZE, n_downsample=1, ngf=4, max_ch=8, ndf=4,
           compute_dtype=torch.float32, device="cpu")
CRITIC = dict(ngf=4, n_layer=3, compute_dtype=torch.float32, device="cpu")


def batches(seed):
    """STEPS global batches of [-1, 1] frames, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.rand(BATCH, SIZE, SIZE, 1) * 2
                              - 1).astype(np.float32)) for _ in range(STEPS)]


def _shard(t, mesh):
    from cistar_tpu_torch.parallel.sharding import shard_batch

    return t if mesh is None else shard_batch(t, mesh)


def r2lae_run(wgan, mesh=None):
    """STEPS ``R2LAE`` steps: per step the metrics, the six nets' Adam
    first moments, and the BatchNorm running statistics."""
    from cistar_tpu_torch.engines.extended import NETS, R2LAE

    eng = R2LAE(wgan=wgan, mesh=mesh, **UDA)
    st = eng.init_state(0)
    out = []
    for radar, lidar in zip(batches(1), batches(2)):
        st, m, _ = eng.train_step(st, _shard(radar, mesh),
                                  _shard(lidar, mesh))
        out.append(({k: float(v) for k, v in m.items()},
                    [st.opts[k].mu_flat.clone() for k in NETS],
                    [b.clone() for s in st.stats.values()
                     for b in s.values()]))
    return out


def critic_run(mesh=None):
    """STEPS critic steps, the interpolation weights drawn from the state's
    generator: per step the metrics and the Adam first moment."""
    from cistar_tpu_torch.engines.extended import R2LImageCritic

    eng = R2LImageCritic(mesh=mesh, **CRITIC)
    st = eng.init_state(0)
    out = []
    for lidar, radar in zip(batches(3), batches(4)):
        st, m = eng.train_step(st, _shard(lidar, mesh), _shard(radar, mesh))
        out.append(({k: float(v) for k, v in m.items()},
                    [st.opt.mu_flat.clone()]))
    return out


def record_shards(log):
    """Wrap ``sharding.shard_batch`` (which ``p2phd_train.train_uda`` looks
    up at each call) so that the slice of every CLI batch (a dict; the
    critic's interpolation weights are a tensor) lands in ``log``; returns
    the original."""
    from cistar_tpu_torch.parallel import sharding

    orig = sharding.shard_batch

    def spy(batch, mesh):
        out = orig(batch, mesh)
        if isinstance(out, dict):
            log.append({k: torch.as_tensor(np.array(v)) for k, v in
                        out.items()})
        return out

    sharding.shard_batch = spy
    return orig


def worker(rank, tmp, cli_args):
    """Rank ``rank`` of WORLD gloo processes: every case, then ``p2phd_train
    --uda`` of each module (``cli_args``: module → arguments), recording
    the batch slice of each step; the results to ``tmp/rank<rank>.pt``."""
    torch.set_num_threads(1)
    from cistar_tpu_torch.apps import p2phd_train
    from cistar_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(
        "cpu", rank, WORLD, "file://" + os.path.join(tmp, "rendezvous"),
        timeout=datetime.timedelta(seconds=120))
    try:
        res = {"r2lae": {w: r2lae_run(w, mesh) for w in (False, True)},
               "critic": critic_run(mesh)}
        res["cli"], res["shards"] = {}, {}
        for module, args in cli_args.items():
            res["shards"][module] = []
            record_shards(res["shards"][module])
            st = p2phd_train.main(args)
            res["cli"][module] = [p.detach().clone() for p in (
                st.d.values() if module == "discriminator" else
                [p for k in ("e", "df", "dr", "dl", "g_lidar", "g_radar")
                 for p in getattr(st, k).values()])]
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        sharding.close_mesh(mesh)
