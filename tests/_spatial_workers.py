"""Workers of ``tests/test_torch_spatial.py`` and
``tests/test_torch_spatial_train.py``: the spatially sharded cases run by
each gloo process, the inputs they share with the one-process references,
and those references.

Kept out of the test files: ``spawn`` re-imports the module that defines a
worker, and this one imports neither JAX nor a test file.
"""

import datetime
import os

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------- #
# the ops (tests/test_spatial.py's shapes), four processes
# --------------------------------------------------------------------------- #
OPS_WORLD = 4


def _randn(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def op_inputs():
    """name → the case's numpy arrays: the NHWC input first, then HWIO
    weights and biases as the JAX ops take them."""
    return {
        "conv_reflect_3x3": (_randn(1, 1, 32, 16, 4),
                             _randn(2, 3, 3, 4, 8, scale=0.1),
                             _randn(3, 8)),
        "conv_reflect_7x7": (_randn(4, 1, 32, 16, 2),
                             _randn(5, 7, 7, 2, 4, scale=0.1)),
        "conv_stride2": (_randn(6, 1, 32, 16, 4),
                         _randn(7, 3, 3, 4, 8, scale=0.1)),
        "conv_transpose": (_randn(8, 1, 16, 8, 6),
                           _randn(9, 3, 3, 6, 4, scale=0.1), _randn(10, 4)),
        "instance_norm": (_randn(11, 2, 32, 8, 4, scale=3.0, shift=1.0),),
        "avg_pool_3s2": (_randn(12, 1, 32, 16, 3),),
        "max_pool2": (_randn(13, 1, 32, 16, 3),),
        "pad_reflect": (_randn(14, 1, 32, 16, 3),),
        "pad_zero": (_randn(15, 1, 32, 16, 3),),
        "pad_replicate": (_randn(16, 1, 32, 16, 3),),
        "halo_exchange": (_randn(17, 1, 32, 16, 3),),
        "mini_generator": (_randn(18, 1, 32, 16, 1),
                           _randn(19, 7, 7, 1, 8, scale=0.1),
                           _randn(20, 3, 3, 8, 16, scale=0.1),
                           _randn(21, 3, 3, 16, 16, scale=0.1),
                           _randn(22, 3, 3, 16, 8, scale=0.1),
                           _randn(23, 7, 7, 8, 1, scale=0.1)),
    }


PAD = 2                  # the pad cases' rows
HALO = (2, 1)            # halo_exchange's rows from above, from below


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _iohw(w):            # HWIO (I = in) → ConvTranspose2d's (in, out, kh, kw)
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))


# the transpose convs' weights among a case's arrays after x
TRANSPOSED = {("conv_transpose", 0), ("mini_generator", 3)}


def _tensors(name, arrays):
    """The case's torch tensors: x, then the weights in PyTorch layouts."""
    x, *rest = arrays
    out = [torch.from_numpy(x)]
    for i, a in enumerate(rest):
        if a.ndim == 1:
            out.append(torch.from_numpy(a))
        else:
            out.append((_iohw if (name, i) in TRANSPOSED else _oihw)(a))
    return out


def op_fns(name):
    """(the slab function ``f(slab, group, *weights)``, the whole-image
    function ``g(x, *weights)`` whose rows, per slab, it must give)."""
    from cistar_tpu_torch.ops import nn as tnn
    from cistar_tpu_torch.parallel import spatial as sp

    def padded(mode, p):
        def whole(x):
            n, h = OPS_WORLD, x.shape[1] // OPS_WORLD
            xc = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                       mode={"zero": "constant"}.get(mode, mode))
            xp = xc.permute(0, 2, 3, 1)
            return torch.cat([xp[:, r * h:r * h + h + 2 * p]
                              for r in range(n)], 1)
        return (lambda s, g: sp.spatial_pad(s, p, mode, g)), whole

    def halo(x):
        n, h = OPS_WORLD, x.shape[1] // OPS_WORLD
        up, down = HALO
        xp = F.pad(x, (0, 0, 0, 0, up, down))
        return torch.cat([xp[:, r * h:r * h + h + up + down]
                          for r in range(n)], 1)

    def mini(g, w1, w2, w3, w4, w5):
        def conv(x, w, stride, pad, mode):
            return sp.spatial_conv2d(x, w, None, stride, pad, mode, g)

        def in_(x):
            return sp.spatial_instance_norm(x, group=g)

        def f(s):
            h = tnn.relu(in_(conv(s, w1, 1, 3, "reflect")))
            h = tnn.relu(in_(conv(h, w2, 2, 1, "zero")))
            h = h + in_(conv(h, w3, 1, 1, "reflect"))
            h = tnn.relu(in_(sp.spatial_conv_transpose2d(h, w4, None, g)))
            return tnn.tanh(conv(h, w5, 1, 3, "reflect"))
        return f

    def mini_whole(x, w1, w2, w3, w4, w5):
        h = tnn.relu(tnn.instance_norm(tnn.conv2d_reflect(x, w1)))
        h = tnn.relu(tnn.instance_norm(tnn.conv2d(h, w2, None, 2, 1)))
        h = h + tnn.instance_norm(tnn.conv2d_reflect(h, w3))
        h = tnn.relu(tnn.instance_norm(
            tnn.conv_transpose2d(h, w4, None, 2, 1, 1)))
        return tnn.tanh(tnn.conv2d_reflect(h, w5))

    return {
        "conv_reflect_3x3": (
            lambda s, g, w, b: sp.spatial_conv2d(s, w, b, 1, 1, "reflect", g),
            lambda x, w, b: tnn.conv2d_reflect(x, w, b)),
        "conv_reflect_7x7": (
            lambda s, g, w: sp.spatial_conv2d(s, w, None, 1, 3, "reflect", g),
            lambda x, w: tnn.conv2d_reflect(x, w)),
        "conv_stride2": (
            lambda s, g, w: sp.spatial_conv2d(s, w, None, 2, 1, "zero", g),
            lambda x, w: tnn.conv2d(x, w, None, 2, 1)),
        "conv_transpose": (
            lambda s, g, w, b: sp.spatial_conv_transpose2d(s, w, b, g),
            lambda x, w, b: tnn.conv_transpose2d(x, w, b, 2, 1, 1)),
        "instance_norm": (
            lambda s, g: sp.spatial_instance_norm(s, group=g),
            tnn.instance_norm),
        "avg_pool_3s2": (lambda s, g: sp.spatial_avg_pool_3s2(s, g),
                         lambda x: tnn.avg_pool2d(x, 3, 2, padding=1)),
        "max_pool2": (lambda s, g: sp.spatial_max_pool2(s, g),
                      lambda x: tnn.max_pool2d(x, 2, 2)),
        "pad_reflect": padded("reflect", PAD),
        "pad_zero": padded("zero", PAD),
        "pad_replicate": padded("replicate", PAD),
        "halo_exchange": (lambda s, g: sp.halo_exchange(s, *HALO, g), halo),
        "mini_generator": (lambda s, g, *w: mini(g, *w)(s), mini_whole),
    }[name]


def projection(shape, seed=99):
    """A fixed random projection: the scalar whose gradient is held."""
    return torch.from_numpy(_randn(seed, *shape))


def grads_of(out, tensors):
    """d(Σ out · projection) / d tensors."""
    return list(torch.autograd.grad((out * projection(out.shape)).sum(),
                                    tensors, allow_unused=False))


def op_whole(name):
    """The whole-image function's output and gradients (one process);
    the slab cases' per-rank rows, side by side in H."""
    ts = [t.requires_grad_(True) for t in _tensors(name, op_inputs()[name])]
    out = op_fns(name)[1](*ts)
    return out.detach(), grads_of(out, ts)


# --------------------------------------------------------------------------- #
# the generators
# --------------------------------------------------------------------------- #
GEN_SIZE = 64
FAMILIES = {"global": dict(ngf=4, n_downsampling=2, n_blocks=2),
            "local": dict(ngf=4, n_downsample_global=2, n_blocks_global=2,
                          n_local_enhancers=1, n_blocks_local=1),
            "UNet": dict(n_residual_blocks=2, in_features=4)}
GRID = dict(ngf=4, n_downsampling=2, n_blocks=1)   # the data × spatial grid
GRID_X = (2, 64, 16, 1)


def generator(family, seed=0):
    """The port's generator of ``family`` from ``seed``."""
    from cistar_tpu_torch.models.pix2pixhd import (GlobalGenerator,
                                                   LocalEnhancer,
                                                   UNetGeneratorHD)

    cls = {"global": GlobalGenerator, "local": LocalEnhancer,
           "UNet": UNetGeneratorHD, "grid": GlobalGenerator}[family]
    torch.manual_seed(seed)
    return cls(input_nc=1, output_nc=1, **FAMILIES.get(family, GRID))


def gen_input(seed=30, shape=(1, GEN_SIZE, GEN_SIZE, 1)):
    return torch.from_numpy(_randn(seed, *shape))


def gen_whole(family):
    """The whole-image forward and its parameter gradients."""
    g = generator(family)
    out = g(gen_input())
    return out.detach(), grads_of(out, list(g.parameters()))


def _all_sum(ts, group=None):
    import torch.distributed as dist

    out = [t.clone() for t in ts]
    for t in out:
        dist.all_reduce(t, group=group)
    return out


def ops_worker(rank, tmp):
    """Rank ``rank`` of OPS_WORLD gloo processes: every op and generator
    case, its gathered outputs and its gradients summed over ranks, to
    ``tmp/rank<rank>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    from cistar_tpu_torch.parallel import sharding
    from cistar_tpu_torch.parallel import spatial as sp
    from cistar_tpu_torch.parallel import spatial_models as sm

    mesh = sharding.make_mesh(
        "cpu", rank, OPS_WORLD, "file://" + os.path.join(tmp, "rendezvous"),
        timeout=datetime.timedelta(seconds=120))
    try:
        group = sp.group_of(mesh)
        res = {"ops": {}, "gen": {}}
        for name, arrays in op_inputs().items():
            ts = [t.requires_grad_(True) for t in _tensors(name, arrays)]
            f = op_fns(name)[0]
            out = sp.sharded_apply(lambda s: f(s, group, *ts[1:]), ts[0],
                                   group)
            res["ops"][name] = (out.detach(), _all_sum(grads_of(out, ts)))
        for family in FAMILIES:
            g = generator(family)
            out = sm.generator_sharded_apply(g, gen_input(), group)
            res["gen"][family] = (out.detach(), _all_sum(
                grads_of(out, list(g.parameters()))))
        # a 2 × 2 data × spatial grid: ranks {0, 1} hold image 0's slabs,
        # {2, 3} image 1's
        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        d = rank // 2
        x = gen_input(31, GRID_X)[d:d + 1]
        with torch.no_grad():
            res["grid"] = sm.global_generator_sharded_apply(
                generator("grid"), x, groups[d])
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        sharding.close_mesh(mesh)


# --------------------------------------------------------------------------- #
# the pix2pixHD step, two processes
# --------------------------------------------------------------------------- #
TRAIN_WORLD, TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS = 2, 64, 2, 2
P2P = {"global": dict(net_g="global", ngf=4, ndf=8, n_downsample_global=2,
                      n_blocks_global=1, n_layers_d=2, num_d=2, pool_size=2),
       "UNet": dict(net_g="UNet", ngf=4, ndf=8, n_blocks_global=1,
                    n_layers_d=2, num_d=2)}


def train_batches(seed):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE,
                                        1).astype(np.float32)),
             torch.from_numpy(np.where(rng.rand(TRAIN_BATCH, TRAIN_SIZE,
                                                TRAIN_SIZE, 1) > 0.8, 1.0,
                                       -1.0).astype(np.float32)))
            for _ in range(TRAIN_STEPS)]


def p2phd_run(net, spatial_mesh=None):
    """TRAIN_STEPS steps on the whole batches: per step the metrics and the
    Adam first moments of G and D; then every parameter and the inference
    path's output on the first batch's labels."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD

    eng = Pix2PixHD(image_size=TRAIN_SIZE, compute_dtype=torch.float32,
                    device="cpu", spatial_mesh=spatial_mesh, **P2P[net])
    st = eng.init_state(0)
    steps = []
    for label, image in train_batches(40):
        st, m, _ = eng.train_step(st, label, None, image)
        steps.append(({k: float(v) for k, v in m.items()},
                      [st.opt_g.mu_flat.clone(), st.opt_d.mu_flat.clone()]))
    params = [p.detach().clone() for p in (*st.g.values(), *st.d.values())]
    return steps, params, eng.infer_step(train_batches(40)[0][0])


def jax_weights_step(path, spatial_mesh=None):
    """One ``global`` step of P2P from the JAX engine's initial weights
    (numpy trees ``{"g", "d"}`` pickled at ``path``) on the first of
    ``train_batches(40)``: the metrics, the fake, and Adam's first moments
    of G and D, per parameter."""
    import pickle

    from cistar_tpu_torch.engines.p2phd import Pix2PixHD

    with open(path, "rb") as f:
        trees = pickle.load(f)
    eng = Pix2PixHD(image_size=TRAIN_SIZE, compute_dtype=torch.float32,
                    device="cpu", spatial_mesh=spatial_mesh, **P2P["global"])
    st = eng.init_state(0)
    eng.load_jax_params(trees["g"], None, trees["d"])
    label, image = train_batches(40)[0]
    st, m, fake = eng.train_step(st, label, None, image)
    return ({k: float(v) for k, v in m.items()}, fake.detach(),
            [t.clone() for t in st.opt_g.mu], [t.clone() for t in st.opt_d.mu])


def train_worker(rank, tmp, cli_args):
    """Rank ``rank`` of TRAIN_WORLD gloo processes: the spatially sharded
    steps of every net of P2P, the step from the JAX engine's weights
    (``tmp/jax_init.pkl``), then the two CLIs with ``--spatial_shard``
    (``cli_args``: the train CLI's and the test CLI's arguments)."""
    torch.set_num_threads(1)
    from cistar_tpu_torch.apps import p2phd_test, p2phd_train
    from cistar_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(
        "cpu", rank, TRAIN_WORLD, "file://" + os.path.join(tmp, "rendezvous"),
        timeout=datetime.timedelta(seconds=120))
    try:
        res = {net: p2phd_run(net, mesh) for net in P2P}
        res["jax"] = jax_weights_step(os.path.join(tmp, "jax_init.pkl"), mesh)
        train_args, test_args = cli_args
        p2phd_train.main(train_args + ["--spatial_shard"])
        torch.distributed.barrier()
        res["test_dir"] = p2phd_test.main(test_args + ["--spatial_shard"])
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        sharding.close_mesh(mesh)
