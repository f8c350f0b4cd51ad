"""Gatys optimization-based style transfer (counterpart of
``cistar_tpu/engines/ist.py``).

Reference flow (``IST/model/engine/transfer_style.py:11-44`` +
``engine/utils.py:17-45``): preprocess content and style, start from the
content, compute the style Gram and content targets, then run 300 L-BFGS
iterations, each a VGG-19 forward and backward to the image. The
coarse-to-fine pass (``engine/hr_transfer_style.py:11-33``) preprocesses
again at ``HRDATA.IMG_SIZE``, starts from the upscaled result and runs
500 more.

The VGG convs run in the compute dtype (bf16 by default, fp32 for strict
parity), the loss and the L-BFGS math in fp32 with TF32 off
(``ops/lbfgs.py::highest_precision``). The weights are prepared once, at
construction: OIHW, in the compute dtype, on the device. A batch of F
frames is one L-BFGS run over a leading frame axis (``optimize_batch``):
the VGG work of all frames goes through one batched forward and backward,
and each frame keeps its own history and step sizes, so its result is its
own ``optimize`` up to the order of sums.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from cistar_tpu_torch.data.transforms import GatysImageTransform
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.models import vgg as vgg_lib
from cistar_tpu_torch.ops.gram import gram_matrix, gram_mse_loss, \
    gram_mse_losses
from cistar_tpu_torch.ops.lbfgs import highest_precision, lbfgs_minimize


class GatysEngine:
    """Gatys style transfer for a fixed config (``cfg`` from
    ``core/config.py::get_ist_cfg_defaults``) and VGG-19 params in the
    ``models/vgg.py`` layout, on ``device`` (CUDA when ``None``)."""

    def __init__(self, cfg, vgg_params: vgg_lib.Params,
                 device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 history_size: int = 100,  # torch.optim.LBFGS's default
                 history_dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.history_size = history_size
        self.history_dtype = history_dtype
        self.style_layers: List[str] = list(cfg.LOSS.STYLE_LAYERS)
        self.content_layers: List[str] = list(cfg.LOSS.CONTENT_LAYERS)
        self.style_weights = [float(w) for w in cfg.LOSS.STYLE_WEIGHTS]
        self.content_weights = [float(w) for w in cfg.LOSS.CONTENT_WEIGHTS]
        self.transform = GatysImageTransform(cfg.DATA.IMG_SIZE,
                                             cfg.DATA.IMAGENET_MEAN)
        self.vgg = vgg_lib.prepare_params(vgg_params, compute_dtype,
                                          self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _features(self, x: torch.Tensor, layers: Sequence[str]
                  ) -> List[torch.Tensor]:
        return vgg_lib.features(self.vgg, x.to(self.compute_dtype), layers)

    # -- the optimization ----------------------------------------------------
    def objective(self, contents, styles
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
        """The Gatys loss of F frames: (F, N, H, W, 3) images → (F,)
        losses, each the weighted sum of its style (Gram MSE) and content
        (feature MSE) terms against the targets of its own content and
        style frames, (F, N, H, W, 3) (styles may have their own H, W)."""
        contents, styles = self._tensor(contents), self._tensor(styles)
        f, n = contents.shape[:2]
        layers = self.style_layers + self.content_layers
        weights = self.style_weights + self.content_weights
        n_style = len(self.style_layers)
        with highest_precision(), torch.no_grad():
            style_t = [gram_matrix(o) for o in self._features(
                styles.flatten(0, 1), self.style_layers)]
            content_t = [o.float() for o in self._features(
                contents.flatten(0, 1), self.content_layers)]

        def loss_fn(imgs: torch.Tensor) -> torch.Tensor:
            outs = self._features(imgs.flatten(0, 1), layers)
            total = 0.0
            for a, out in enumerate(outs):
                if a < n_style:
                    per_image = gram_mse_losses(out, style_t[a])
                else:
                    per_image = (out.float() - content_t[a - n_style]
                                 ).square().mean(dim=(1, 2, 3))
                total = total + weights[a] * per_image.view(f, n).mean(1)
            return total

        return loss_fn

    def optimize_batch(self, contents, styles, init_images=None,
                       max_iters: Optional[int] = None,
                       mark: Optional[Callable[[str], None]] = None):
        """F independent Gatys optimizations as one L-BFGS run over the
        frame axis, from the contents or ``init_images``. Inputs are (F, N,
        H, W, 3) (N = 1 from the transform). Returns ``(images (F, N, H, W,
        3), final losses (F,), loss history (F, max_iters))``, on the
        device. ``mark`` goes to ``lbfgs_minimize`` (a per-phase timing)."""
        max_iters = int(max_iters or self.cfg.LOSS.MAX_ITER)
        init = contents if init_images is None else init_images
        return lbfgs_minimize(self.objective(contents, styles),
                              self._tensor(init), max_iters, lr=1.0,
                              history_size=self.history_size,
                              history_dtype=self.history_dtype, mark=mark)

    def optimize(self, content, style, init_image=None,
                 max_iters: Optional[int] = None,
                 mark: Optional[Callable[[str], None]] = None):
        """The L-BFGS style optimization of one NHWC (N, H, W, 3) image:
        :meth:`optimize_batch` at F = 1. Returns ``(image, loss,
        losses)``."""
        init = None if init_image is None else self._tensor(init_image)[None]
        imgs, loss, losses = self.optimize_batch(
            self._tensor(content)[None], self._tensor(style)[None], init,
            max_iters, mark)
        return imgs[0], loss[0], losses[0]

    # -- PIL-level drivers (the reference's entry points) --------------------
    def transfer_style(self, content_img, style_img,
                       max_iters: Optional[int] = None):
        """``do_transfer_style``: PIL in → stylized PIL out."""
        content = self.transform.preparation(content_img)
        style = self.transform.preparation(style_img)
        out, _, _ = self.optimize(content, style, max_iters=max_iters)
        return self.transform.post_preparation(out.cpu().numpy())

    def transfer_style_batch(self, content_imgs, style_img,
                             max_iters: Optional[int] = None):
        """F PIL frames → F stylized PILs, each group of frames with one
        preprocessed shape through one :meth:`optimize_batch`; each result
        is its frame's :meth:`transfer_style` up to the order of sums."""
        style = self.transform.preparation(style_img)
        preps = [self.transform.preparation(im) for im in content_imgs]
        outs: List = [None] * len(preps)
        groups: Dict[tuple, List[int]] = {}
        for i, c in enumerate(preps):
            groups.setdefault(c.shape, []).append(i)
        for idxs in groups.values():
            contents = np.stack([preps[i] for i in idxs])
            styles = np.repeat(style[None], len(idxs), axis=0)
            imgs, _, _ = self.optimize_batch(contents, styles,
                                             max_iters=max_iters)
            imgs = imgs.cpu().numpy()
            for j, i in enumerate(idxs):
                outs[i] = self.transform.post_preparation(imgs[j])
        return outs

    def hr_transfer_style(self, content_img, style_img, lr_result_img,
                          max_iters: Optional[int] = None):
        """The coarse-to-fine pass (``do_hr_transfer_style``): content and
        style preprocessed at ``HRDATA.IMG_SIZE``, started from the
        upscaled LR result, ``HRLOSS.MAX_ITER`` more iterations."""
        hr = GatysImageTransform(self.cfg.HRDATA.IMG_SIZE,
                                 self.cfg.DATA.IMAGENET_MEAN)
        out, _, _ = self.optimize(
            hr.preparation(content_img), hr.preparation(style_img),
            init_image=hr.preparation(lr_result_img),
            max_iters=int(max_iters or self.cfg.HRLOSS.MAX_ITER))
        return hr.post_preparation(out.cpu().numpy())

    # -- optimize_new variants (engine/utils.py:47-102) ----------------------
    def optimize_single_target(self, content, style,
                               content_only: bool = False,
                               style_only: bool = False,
                               opt: str = "LBFGS", init_image=None,
                               adam_lr: float = 1e-3):
        """``optimize_new``: a content-only or style-only objective, with
        the reference's quirks: the loss is negated (``utils.py:92``) and
        the loop stops after one ``optimizer.step`` (``utils.py:101``), so
        20 L-BFGS iterations (torch's ``max_iter``) or one Adam step, whose
        first step is ``lr·sign(g)``. Returns ``(image, loss)``."""
        if content_only == style_only:
            raise ValueError("choose exactly one of content_only and "
                             "style_only")
        content, style = self._tensor(content), self._tensor(style)
        x0 = content if init_image is None else self._tensor(init_image)
        with highest_precision():
            with torch.no_grad():
                if content_only:
                    layers, weights = self.content_layers, \
                        self.content_weights
                    targets = [o.float()
                               for o in self._features(content, layers)]
                else:
                    layers, weights = self.style_layers, self.style_weights
                    targets = [gram_matrix(o)
                               for o in self._features(style, layers)]

            def loss_fn(img: torch.Tensor) -> torch.Tensor:
                total = 0.0
                for w, o, t in zip(weights, self._features(img, layers),
                                   targets):
                    term = ((o.float() - t).square().mean() if content_only
                            else gram_mse_loss(o, t))
                    total = total + w * term
                return -total

            if opt == "LBFGS":
                x, loss, _ = lbfgs_minimize(
                    lambda xs: loss_fn(xs[0])[None], x0[None], max_iters=20,
                    history_size=self.history_size)
                return x[0], loss[0]
            img = x0.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(loss_fn(img), img)
            x = x0 - adam_lr * torch.sign(g)
            with torch.no_grad():
                return x, loss_fn(x)

    # -- saliency (engine/utils.py:104-161) ----------------------------------
    def saliency(self, image, layers: Sequence[str],
                 weights: Sequence[float]) -> torch.Tensor:
        """The gradient, with respect to the image, of the negated weighted
        sum of the activations of ``layers``."""
        img = self._tensor(image).requires_grad_(True)
        with highest_precision(), torch.enable_grad():
            outs = self._features(img, list(layers))
            obj = -sum(float(w) * o.float().sum()
                       for w, o in zip(weights, outs))
            (g,) = torch.autograd.grad(obj, img)
        return g
