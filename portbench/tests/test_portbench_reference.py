"""The plain reference against the port's CPU path at small widths, in
float32: the generators, the discriminator, Adam and one train step."""

import numpy as np
import pytest
import torch

from _portbench_small import small
from portbench import weights
from portbench.reference import p2phd as R
from portbench.traffic import train_staged as T


def _x(n, size, c=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, size, size, c, generator=g) * 2 - 1


@pytest.mark.parametrize("cell", ["msrb7_512.int8_b8", "global_512.int8_b16"])
def test_generator_matches_the_port(cell):
    from cistar_tpu_torch.models.pix2pixhd import define_g
    _, cfg = small(cell, ngf=8, n_blocks_global=2)
    g = define_g(cfg["netG"], 1, 1, cfg["ngf"], cfg["n_downsample_global"],
                 cfg["n_blocks_global"])
    w = weights.draw(R.generator_spec(cfg), 11, "cpu")
    weights.load_into(g, w)
    x = _x(2, cfg["fineSize"])
    with torch.no_grad():
        want = g(x)
    got = R.generate_nhwc(cfg, w, x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def test_discriminator_matches_the_port():
    from cistar_tpu_torch.models.pix2pixhd import define_d
    _, cfg = small("msrb7_512.train_b1")
    d = define_d(2, cfg["ndf"], cfg["n_layers_D"], num_d=cfg["num_D"])
    w = weights.draw(R.discriminator_spec(cfg), 5, "cpu")
    weights.load_into(d, w)
    x = _x(2, 64, 2)
    with torch.no_grad():
        want = d(x)
        got = R.discriminator(cfg, w, x.permute(0, 3, 1, 2))
    for ws, gs in zip(want, got):
        assert len(ws) == len(gs) == cfg["n_layers_D"] + 2
        for a, b in zip(ws, gs):
            assert float((a - b.permute(0, 2, 3, 1)).abs().max()) < 1e-4


def test_adam_matches_the_port():
    from cistar_tpu_torch.core.optim import AdamState, adam_step
    g = torch.Generator().manual_seed(3)
    p0 = {f"p{i}": torch.randn(5, 4, generator=g) for i in range(3)}
    grads = [{k: torch.randn(5, 4, generator=g) for k in p0}
             for _ in range(3)]
    mine = {k: v.clone() for k, v in p0.items()}
    port = [v.clone() for v in p0.values()]
    opt, st = R.Adam(mine, 1e-2, 0.5), AdamState(port)
    for gr in grads:
        opt.step(mine, gr)
        adam_step(port, list(gr.values()), st, torch.tensor(1e-2),
                  torch.tensor(True), b1=0.5)
    for a, b in zip(mine.values(), port):
        assert float((a - b).abs().max()) < 1e-6


def test_train_step_matches_the_port():
    cell, cfg = small("msrb7_512.train_b1")
    from _portbench_small import ctx as make_ctx
    c = make_ctx("msrb7_512.train_b1", 13, cell, cfg)
    labels, images = T.pairs(c)
    eng, state = T.build(c)
    state, m, _ = eng.train_step(state, labels[0], None, images[0])
    ref = T.reference(c, labels, images, R.FP32)
    got = np.array([float(m[k]) for k in T.LOSSES])
    np.testing.assert_allclose(got, ref["losses"][0], rtol=1e-4)
    c1 = 0.5
    for net, opt in ((0, state.opt_g), (1, state.opt_d)):
        prog = T._norms(opt.mu).numpy() / c1
        r = ref["grad"][net]
        keep = r >= T.KEEP * np.median(r)
        np.testing.assert_allclose(prog[keep], r[keep], rtol=1e-3)
