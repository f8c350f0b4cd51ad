"""Plain fp32 pix2pixHD: the `UNet` (MSRB) and `global` generators, the
multiscale PatchGAN discriminator, LSGAN + feature matching, Adam, and the
recipe's train step (pix2pixHD's `models/networks.py`,
`models/pix2pixHD_model.py`; p2pHD's `UNetGenerator` / `MSRB`).

Independent of the program: it imports only torch, computes in NCHW
float32 through `torch.nn.functional`, instance norm with two-pass moments.
Callers turn TF32 off (`fp32_exact`). Parameters are a dict keyed by the
names that `param_specs` lists; the harness draws them and hands the same
values to the program.

`Precision` is the hook of the lower-precision controls: it rounds the
operands of chosen convolutions (fp8 e4m3 per tensor, or int4 with one
scale per image and per output channel) and computes the convolution in
float32 on the rounded values.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...]]]

EPS_IN = 1e-5
FP8_MAX = 448.0   # largest finite float8_e4m3fn


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and matmuls inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --------------------------------------------------------------------------- #
# lower precision for the controls
# --------------------------------------------------------------------------- #
def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor, back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def round_int4(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 ([-7, 7]) with one scale per entry of axis 0 (an
    image of an activation, an output channel of a weight)."""
    dims = tuple(range(1, t.dim()))
    s = t.detach().abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / 7.0
    return torch.clamp(torch.round(t / s), -7, 7) * s


_ROUND = {"fp8": round_fp8, "int4": round_int4}


class _Rounded(torch.autograd.Function):
    """Rounds the operand on the way forward and its gradient on the way
    back, so that a control's backward runs at its precision too."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, kind: str) -> torch.Tensor:
        ctx.kind = kind
        return _ROUND[kind](t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _ROUND[ctx.kind](g), None


class Precision:
    """Which convolutions take rounded operands (and pass rounded
    gradients back to them): ``trunk`` (the blocks
    the int8 engine quantises: MSRB branch convs, resnet block convs) and
    ``rest`` (every other conv and transposed conv, D's included), each
    ``None`` (float32) or ``"fp8"`` / ``"int4"``."""

    def __init__(self, trunk: Optional[str] = None,
                 rest: Optional[str] = None):
        self.trunk, self.rest = trunk, rest

    def __call__(self, x: torch.Tensor, w: torch.Tensor, part: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        kind = self.trunk if part == "trunk" else self.rest
        if kind is None:
            return x, w
        return _Rounded.apply(x, kind), _Rounded.apply(w, kind)


FP32 = Precision()


# --------------------------------------------------------------------------- #
# ops
# --------------------------------------------------------------------------- #
def inorm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS_IN)


def conv(x: torch.Tensor, p: Params, name: str, prec: Precision,
         stride: int = 1, pad: int = 0, reflect: bool = False,
         part: str = "rest") -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    if reflect and pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        pad = 0
    x, w = prec(x, w, part)
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def conv_t(x: torch.Tensor, p: Params, name: str, prec: Precision
           ) -> torch.Tensor:
    """3×3 stride-2 transposed conv, padding 1, output padding 1."""
    x, w = prec(x, p[name + ".weight"], "rest")
    return F.conv_transpose2d(x, w, p[name + ".bias"], stride=2, padding=1,
                              output_padding=1)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


# --------------------------------------------------------------------------- #
# parameter lists
# --------------------------------------------------------------------------- #
def _conv_spec(name: str, cout: int, cin: int, k: int) -> Spec:
    return [(name + ".weight", (cout, cin, k, k)), (name + ".bias", (cout,))]


def generator_spec(cfg: dict) -> Spec:
    """G's parameters, names and shapes, for ``cfg["netG"]`` "UNet" or
    "global"."""
    f, cin, cout = cfg["ngf"], cfg["input_nc"], cfg["output_nc"]
    nb = cfg["n_blocks_global"]
    if cfg["netG"] == "UNet":
        s = _conv_spec("init_block.conv", f, cin, 7)
        for i in range(3):
            s += _conv_spec(f"down_conv.{i}", f * 2 ** (i + 1), f * 2 ** i, 7)
        n = f * 8
        for i in range(nb):
            b = f"msrb.{i}."
            s += (_conv_spec(b + "b00_conv", n, n, 3)
                  + _conv_spec(b + "b01_conv", n, n, 5)
                  + _conv_spec(b + "b10_conv", n, 2 * n, 3)
                  + _conv_spec(b + "b11_conv", n, 2 * n, 5)
                  + _conv_spec(b + "out_conv", n, 2 * n, 1))
        for i in range(3):
            ci, co = 2 * n // 2 ** i, n // 2 ** (i + 1)
            s += [(f"up_convt.{i}.weight", (ci, co, 3, 3)),
                  (f"up_convt.{i}.bias", (co,))]
        return s + _conv_spec("output_layer.conv", cout, f, 7)
    if cfg["netG"] == "global":
        nd = cfg["n_downsample_global"]
        s = _conv_spec("trunk.stem.conv", f, cin, 7)
        for i in range(nd):
            s += _conv_spec(f"trunk.down.{i}.conv", f * 2 ** (i + 1),
                            f * 2 ** i, 3)
        n = f * 2 ** nd
        for i in range(nb):
            s += (_conv_spec(f"trunk.res.{i}.conv1", n, n, 3)
                  + _conv_spec(f"trunk.res.{i}.conv2", n, n, 3))
        for i in range(nd):
            ci = f * 2 ** (nd - i)
            s += [(f"trunk.up.{i}.convt.weight", (ci, ci // 2, 3, 3)),
                  (f"trunk.up.{i}.convt.bias", (ci // 2,))]
        return s + _conv_spec("head.conv", cout, f, 7)
    raise ValueError(f"netG {cfg['netG']!r} has no reference")


def d_channels(cfg: dict) -> List[int]:
    nf = [cfg["ndf"]]
    for _ in range(cfg["n_layers_D"]):
        nf.append(min(nf[-1] * 2, 512))
    return nf


def discriminator_spec(cfg: dict) -> Spec:
    """The multiscale D's parameters: ``num_D`` PatchGANs of 4×4 convs on
    the label and the image side by side."""
    nl, nf = cfg["n_layers_D"], d_channels(cfg)
    cin = cfg["input_nc"] + cfg["output_nc"]
    s: Spec = []
    for k in range(cfg["num_D"]):
        p = f"scale_{k}.layer"
        s += _conv_spec(p + "0_conv", nf[0], cin, 4)
        for n in range(1, nl + 1):
            s += _conv_spec(f"{p}{n}_conv", nf[n], nf[n - 1], 4)
        s += _conv_spec(f"{p}{nl + 1}_conv", 1, nf[nl], 4)
    return s


# --------------------------------------------------------------------------- #
# generators
# --------------------------------------------------------------------------- #
def _msrb(p: Params, b: str, x: torch.Tensor, prec: Precision
          ) -> torch.Tensor:
    cat1 = torch.cat([F.relu(conv(x, p, b + "b00_conv", prec, pad=1,
                                  part="trunk")),
                      F.relu(conv(x, p, b + "b01_conv", prec, pad=2,
                                  part="trunk"))], 1)
    cat2 = torch.cat([F.relu(conv(cat1, p, b + "b10_conv", prec, pad=1,
                                  part="trunk")),
                      F.relu(conv(cat1, p, b + "b11_conv", prec, pad=2,
                                  part="trunk"))], 1)
    # the 1×1 fuse: outside the quantised branches in the int8 engine
    return conv(cat2, p, b + "out_conv", FP32)


def _unet(cfg: dict, p: Params, x: torch.Tensor, prec: Precision
          ) -> torch.Tensor:
    h = F.relu(inorm(conv(x, p, "init_block.conv", prec, pad=3,
                          reflect=True)))
    skips = []
    for i in range(3):
        h = F.relu(inorm(conv(h, p, f"down_conv.{i}", prec, stride=2,
                              pad=3)))
        skips.append(h)
    for i in range(cfg["n_blocks_global"]):
        h = _msrb(p, f"msrb.{i}.", h, prec)
    for i in range(3):
        h = F.relu(inorm(conv_t(torch.cat([h, skips[2 - i]], 1), p,
                                f"up_convt.{i}", prec)))
    return torch.tanh(conv(h, p, "output_layer.conv", prec, pad=3,
                           reflect=True))


def _global(cfg: dict, p: Params, x: torch.Tensor, prec: Precision
            ) -> torch.Tensor:
    h = F.relu(inorm(conv(x, p, "trunk.stem.conv", prec, pad=3,
                          reflect=True)))
    nd = cfg["n_downsample_global"]
    for i in range(nd):
        h = F.relu(inorm(conv(h, p, f"trunk.down.{i}.conv", prec, stride=2,
                              pad=1)))
    for i in range(cfg["n_blocks_global"]):
        b = f"trunk.res.{i}."
        r = F.relu(inorm(conv(h, p, b + "conv1", prec, pad=1, reflect=True,
                              part="trunk")))
        h = h + inorm(conv(r, p, b + "conv2", prec, pad=1, reflect=True,
                           part="trunk"))
    for i in range(nd):
        h = F.relu(inorm(conv_t(h, p, f"trunk.up.{i}.convt", prec)))
    return torch.tanh(conv(h, p, "head.conv", prec, pad=3, reflect=True))


def generator(cfg: dict, p: Params, x: torch.Tensor,
              prec: Precision = FP32) -> torch.Tensor:
    """G on NCHW ``x``: NCHW out in [-1, 1]."""
    return (_unet if cfg["netG"] == "UNet" else _global)(cfg, p, x, prec)


def generate_nhwc(cfg: dict, p: Params, x: torch.Tensor,
                  prec: Precision = FP32, block: int = 4) -> torch.Tensor:
    """G on NHWC ``x`` in blocks of ``block`` images, without autograd:
    NHWC float32."""
    outs = []
    with torch.no_grad():
        for i in range(0, x.shape[0], block):
            xb = x[i:i + block].permute(0, 3, 1, 2).float().contiguous()
            outs.append(generator(cfg, p, xb, prec).permute(0, 2, 3, 1))
    return torch.cat(outs)


# --------------------------------------------------------------------------- #
# discriminator and losses
# --------------------------------------------------------------------------- #
def _patch_d(cfg: dict, p: Params, k: int, x: torch.Tensor,
             prec: Precision) -> List[torch.Tensor]:
    nl = cfg["n_layers_D"]
    pre = f"scale_{k}.layer"
    h = lrelu(conv(x, p, pre + "0_conv", prec, stride=2, pad=2))
    feats = [h]
    for n in range(1, nl + 1):
        h = lrelu(inorm(conv(h, p, f"{pre}{n}_conv", prec,
                             stride=2 if n < nl else 1, pad=2)))
        feats.append(h)
    feats.append(conv(h, p, f"{pre}{nl + 1}_conv", prec, pad=2))
    return feats


def discriminator(cfg: dict, p: Params, x: torch.Tensor,
                  prec: Precision = FP32) -> List[List[torch.Tensor]]:
    """Every layer's output of each scale; scale ``num_D − 1`` sees the
    full image, each next one the input average-pooled once more."""
    out, inp, nd = [], x, cfg["num_D"]
    for i in range(nd):
        out.append(_patch_d(cfg, p, nd - 1 - i, inp, prec))
        if i != nd - 1:
            inp = F.avg_pool2d(inp, 3, 2, 1, count_include_pad=False)
    return out


def lsgan(preds: Sequence[Sequence[torch.Tensor]], real: bool
          ) -> torch.Tensor:
    t = 1.0 if real else 0.0
    return sum(torch.mean(torch.square(s[-1] - t)) for s in preds)


# --------------------------------------------------------------------------- #
# Adam and the train step
# --------------------------------------------------------------------------- #
class Adam:
    """optax's Adam: ``mu``, ``nu``, bias-corrected, eps outside the root."""

    def __init__(self, params: Params, lr: float, b1: float,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            params[k].sub_(self.lr * upd)


def train_step(cfg: dict, g: Params, d: Params, opt_g: Adam, opt_d: Adam,
               label: torch.Tensor, image: torch.Tensor,
               prec: Precision = FP32) -> Tuple[Dict[str, float],
                                                Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """One step of the recipe on NHWC ``label`` / ``image``: G's LSGAN and
    feature-matching loss, G's Adam step, then D on the detached fake of
    the same forward, stepped only where its loss is at least
    ``d_loss_floor``. Returns the losses and both gradients."""
    lab = label.permute(0, 3, 1, 2).float().contiguous()
    img = image.permute(0, 3, 1, 2).float().contiguous()
    bs = lab.shape[0]
    fake = generator(cfg, g, lab, prec)
    both = discriminator(cfg, d, torch.cat([torch.cat([lab, fake], 1),
                                            torch.cat([lab, img], 1)]), prec)
    pf = [[t[:bs] for t in s] for s in both]
    pr = [[t[bs:] for t in s] for s in both]
    g_gan = lsgan(pf, True)
    w = 4.0 / (cfg["n_layers_D"] + 1) / cfg["num_D"] * cfg["lambda_feat"]
    feat = sum(w * torch.mean(torch.abs(pf[i][j] - pr[i][j].detach()))
               for i in range(cfg["num_D"]) for j in range(len(pf[i]) - 1))
    gg = torch.autograd.grad(g_gan + feat, list(g.values()))
    g_grads = dict(zip(g, gg))
    opt_g.step(g, g_grads)

    fake = fake.detach()
    both = discriminator(cfg, d, torch.cat([torch.cat([lab, fake], 1),
                                            torch.cat([lab, img], 1)]), prec)
    d_fake = lsgan([[t[:bs] for t in s] for s in both], False)
    d_real = lsgan([[t[bs:] for t in s] for s in both], True)
    loss_d = (d_fake + d_real) * 0.5
    dg = torch.autograd.grad(loss_d, list(d.values()))
    d_grads = dict(zip(d, dg))
    if float(loss_d.detach()) >= cfg["d_loss_floor"]:
        opt_d.step(d, d_grads)
    losses = {"G_GAN": float(g_gan.detach()),
              "G_GAN_Feat": float(feat.detach()),
              "D_real": float(d_real.detach()),
              "D_fake": float(d_fake.detach())}
    return losses, g_grads, d_grads
