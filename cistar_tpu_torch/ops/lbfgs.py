"""L-BFGS with ``torch.optim.LBFGS`` semantics over a batch of independent
problems (counterpart of ``cistar_tpu/ops/lbfgs.py``).

The semantics are the reference's (``IST/model/engine/utils.py:17-45``):
``lr=1``, ``history_size=100``, no line search, curvature pairs kept only
when ``yᵀs > 1e-10``, a first step scaled by ``min(1, 1/‖g‖₁)·lr``, and
torch's tolerances, each a stop of one ``LBFGS.step`` call inside the
reference's loop, which calls it again until its count of closure
evaluations is spent. So a gradient below ``tolerance_grad`` or a
direction that is not descent stops a frame for good (its step is zeroed
from then on), while a step or loss change below ``tolerance_change``
costs the frame one iteration that re-evaluates without moving (the
closure call that starts the next ``step``) and the iteration goes on.
The JAX package latches on those two as well; in bf16 that freezes its
run after the first step, whose 1/‖g‖₁ scale leaves the bf16 image, and
so the loss, unchanged. The two-loop recursion is its matrix form, as in the JAX package: the
backward-loop alphas and forward-loop betas each solve a unit lower
triangular m×m system built from cached S·Yᵀ and Y·Yᵀ, so an iteration
reads the (2m, n) history of S and Y rows twice: once for the direction
(``Hᵀ·coef``) and once for the new Gram row and column and the ``S·g`` /
``Y·g`` caches of the next direction (``H·[s y g]``).

Where JAX runs one problem and ``vmap``s it, every tensor here has a
leading frame axis F: per-frame ring heads, counts, latches and ρ,
batched triangular solves, and ``torch.bmm`` for the two history passes.
One problem is the case F = 1. The loop reads no device value on the
host, so it never waits for the card inside an iteration.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import torch


@contextlib.contextmanager
def highest_precision() -> Iterator[None]:
    """fp32 matmuls and convs in true fp32, JAX's ``Precision.HIGHEST``:
    TF32 off for cuBLAS and cuDNN (cuDNN's is on by default), and no
    reduced-precision reductions in bf16 GEMMs; the flags come back after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32,
             cuda.allow_bf16_reduced_precision_reduction)
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    cuda.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (cuda.allow_tf32, cudnn.allow_tf32,
         cuda.allow_bf16_reduced_precision_reduction) = saved


class LBFGSState(NamedTuple):
    x: torch.Tensor         # (F, n) flat iterates
    g: torch.Tensor         # (F, n) gradients at x
    loss: torch.Tensor      # (F,) losses at x
    hist: torch.Tensor      # (F, 2m, n) rings: rows [0, m) = S, [m, 2m) = Y
    rho: torch.Tensor       # (F, m) 1/(yᵀs)
    sy: torch.Tensor        # (F, m, m) cached S·Yᵀ (sy[i, j] = s_iᵀ y_j)
    yy: torch.Tensor        # (F, m, m) cached Y·Yᵀ
    sg: torch.Tensor        # (F, m) cached S·g for the current g
    yg: torch.Tensor        # (F, m) cached Y·g for the current g
    head: torch.Tensor      # (F,) int64 ring heads (next write slot)
    count: torch.Tensor     # (F,) int64 valid pairs (≤ m)
    k: int                  # iterations taken (the same for every frame)
    done: torch.Tensor      # (F,) bool: stopped for good
    pause: torch.Tensor     # (F,) bool: this iteration re-evaluates only


def _permuted(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(F, m, m) ``a`` → ``a[f, order[f, i], order[f, j]]``."""
    f, m = order.shape
    rows = a.gather(1, order[:, :, None].expand(f, m, m))
    return rows.gather(2, order[:, None, :].expand(f, m, m))


def _solve_unit_lower(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(mat, rhs[..., None],
                                         upper=False)[..., 0]


def _direction(state: LBFGSState, m: int) -> torch.Tensor:
    """(F, n) ``d = −H·g`` by the matrix form of the two-loop recursion.

    The backward loop visits pairs newest → oldest, the forward loop
    oldest → newest. With L the strict lower triangle of S·Yᵀ in that
    order:

      (I + diag(ρ)·L) α = diag(ρ)·S·g               (backward-loop alphas)
      r₀ = γ (g − Yᵀα)
      (I + diag(ρ')·L') β = diag(ρ')·(Y·r₀ + L'·α)   (forward-loop betas)
      d  = −(γ·g + Hᵀ·[α − β; −γα])

    Slots past ``count`` have ρ = 0 and reduce to identity rows, so with
    no pair stored (the first iteration) this is exactly ``−g``."""
    g, rho = state.g, state.rho
    dev = g.device
    idx = torch.arange(m, device=dev)
    valid = idx < state.count[:, None]
    ord_bwd = (state.head[:, None] - 1 - idx) % m
    ord_fwd = (state.head[:, None] - state.count[:, None] + idx) % m
    eye = torch.eye(m, device=dev)

    rho_b = torch.where(valid, rho.gather(1, ord_bwd), 0.0)
    l_b = torch.tril(_permuted(state.sy, ord_bwd), -1)
    alpha_b = _solve_unit_lower(eye + rho_b[:, :, None] * l_b,
                                rho_b * state.sg.gather(1, ord_bwd))
    alpha = torch.zeros_like(alpha_b).scatter(1, ord_bwd, alpha_b)

    # H0 scaling γ = (yᵀs)/(yᵀy) of the newest pair
    last = ((state.head - 1) % m)[:, None]
    has = state.count > 0
    ys_last = torch.where(
        has, 1.0 / torch.clamp(rho.gather(1, last)[:, 0], min=1e-38), 1.0)
    yy_last = torch.diagonal(state.yy, dim1=1, dim2=2).gather(1, last)[:, 0]
    gamma = torch.where(has, ys_last / torch.clamp(yy_last, min=1e-38), 1.0)

    yr0 = gamma[:, None] * (state.yg
                            - torch.bmm(state.yy, alpha[:, :, None])[..., 0])

    rho_f = torch.where(valid, rho.gather(1, ord_fwd), 0.0)
    # (Y·Sᵀ)[i, j] = sy[j, i] in the permuted order
    l_f = torch.tril(_permuted(state.sy, ord_fwd).transpose(1, 2), -1)
    alpha_f = alpha.gather(1, ord_fwd)
    rhs2 = rho_f * (yr0.gather(1, ord_fwd)
                    + torch.bmm(l_f, alpha_f[:, :, None])[..., 0])
    beta_f = _solve_unit_lower(eye + rho_f[:, :, None] * l_f, rhs2)
    beta = torch.zeros_like(beta_f).scatter(1, ord_fwd, beta_f)

    # the one full-history pass of the direction
    coef = torch.cat([alpha - beta, -gamma[:, None] * alpha], dim=1)
    hd = state.hist.dtype
    return -(gamma[:, None] * g
             + torch.bmm(coef.to(hd)[:, None, :], state.hist)[:, 0].float())


def _set_row(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor,
             store: torch.Tensor) -> torch.Tensor:
    """(F, m, m) ``a`` with row ``i[f]`` set to ``v[f]`` where ``store[f]``."""
    ix = i[:, None, None].expand(-1, 1, a.shape[2])
    old = a.gather(1, ix)[:, 0]
    return a.scatter(1, ix, torch.where(store[:, None], v, old)[:, None])


def _set_col(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor,
             store: torch.Tensor) -> torch.Tensor:
    """(F, m, m) ``a`` with column ``i[f]`` set to ``v[f]`` where
    ``store[f]``."""
    ix = i[:, None, None].expand(-1, a.shape[1], 1)
    old = a.gather(2, ix)[..., 0]
    return a.scatter(2, ix, torch.where(store[:, None], v, old)[..., None])


def value_and_grad_fn(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                      shape: torch.Size,
                      mark: Optional[Callable[[str], None]] = None
                      ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """(F, n) flat iterates → their (F,) losses and (F, n) gradients, fp32,
    for a ``loss_fn`` of (F, …) = ``shape`` tensors: the gradient of the
    losses' sum, which is each frame's own when each loss depends on its
    frame only."""
    mark = mark or (lambda label: None)

    def value_and_grad(flat: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        flat = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            losses = loss_fn(flat.view(shape)).float()
            mark("forward + loss")
            (grad,) = torch.autograd.grad(losses.sum(), flat)
        mark("backward")
        return losses.detach(), grad.float()

    return value_and_grad


def init_state(value_and_grad, x0: torch.Tensor, history_size: int = 100,
               history_dtype: torch.dtype = torch.float32) -> LBFGSState:
    """The state at ``x0`` (F, …): its losses and gradients, an empty
    history of ``history_size`` pairs in ``history_dtype``."""
    x = x0.detach().reshape(x0.shape[0], -1).float()
    f, n = x.shape
    m, dev = int(history_size), x.device
    loss, g = value_and_grad(x)
    return LBFGSState(
        x=x, g=g, loss=loss,
        hist=torch.zeros(f, 2 * m, n, dtype=history_dtype, device=dev),
        rho=torch.zeros(f, m, device=dev),
        sy=torch.zeros(f, m, m, device=dev),
        yy=torch.zeros(f, m, m, device=dev),
        sg=torch.zeros(f, m, device=dev),
        yg=torch.zeros(f, m, device=dev),
        head=torch.zeros(f, dtype=torch.int64, device=dev),
        count=torch.zeros(f, dtype=torch.int64, device=dev),
        k=0,
        done=torch.zeros(f, dtype=torch.bool, device=dev),
        pause=torch.zeros(f, dtype=torch.bool, device=dev))


def lbfgs_minimize(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iters: int,
    lr: float = 1.0,
    history_size: int = 100,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    history_dtype: torch.dtype = torch.float32,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize F independent problems at once with torch-LBFGS semantics.

    ``x0`` is (F, …), one problem a frame; ``loss_fn`` maps such a tensor
    to the (F,) losses, each a function of its own frame only: each
    frame's gradient is then exactly its own, as the gradient of their
    sum. Returns ``(x_opt, final_losses (F,), loss_history (F,
    max_iters))``. The history is stored in ``history_dtype`` (bf16 halves
    its traffic); ρ and the Gram caches come from the stored values.
    ``mark(label)``, when given, is called at the end of each phase of an
    iteration (``direction``, ``forward + loss``, ``backward``, ``history
    update``), for a per-phase timing.
    """
    mark = mark or (lambda label: None)
    value_and_grad = value_and_grad_fn(loss_fn, x0.shape, mark)
    with highest_precision():
        st = init_state(value_and_grad, x0, history_size, history_dtype)
        history = torch.empty(x0.shape[0], max_iters, device=x0.device)
        for k in range(max_iters):
            st = step(st, value_and_grad, lr, tolerance_grad,
                      tolerance_change, mark)
            history[:, k] = st.loss
            mark("history update")
    return st.x.view(x0.shape), st.loss, history


def step(st: LBFGSState, value_and_grad, lr: float = 1.0,
         tolerance_grad: float = 1e-7, tolerance_change: float = 1e-9,
         mark: Optional[Callable[[str], None]] = None) -> LBFGSState:
    """One L-BFGS iteration of every frame: the next state. It writes the
    new pair into ``st.hist`` in place."""
    mark = mark or (lambda label: None)
    f, n = st.x.shape
    m = st.rho.shape[1]
    d = _direction(st, m)
    mark("direction")
    # the first step is scaled by min(1, 1/‖g‖₁) (torch's rule)
    if st.k == 0:
        t = torch.clamp(1.0 / torch.clamp(st.g.abs().sum(1), min=1e-38),
                        max=1.0) * lr
    else:
        t = torch.full((f,), lr, device=st.x.device)
    gtd = (st.g * d).sum(1)
    # torch stops before stepping along a direction that is not descent
    bad_dir = gtd > -tolerance_change
    # A stopped or pausing frame gets a zero step: x stays put, y = 0
    # stores no pair, and the loss evaluates to the same value.
    s = torch.where(st.done | st.pause | bad_dir, 0.0, t)[:, None] * d
    x = st.x + s
    loss, g = value_and_grad(x)

    y = g - st.g
    ys = (y * s).sum(1)
    store = (ys > 1e-10) & ~st.done
    head = st.head
    # the new pair goes into ring slot ``head`` (rows head and m + head),
    # rounded to the history's dtype; a frame that stores nothing writes
    # its old rows back
    hist = st.hist
    hd = hist.dtype
    rows = hist.view(f * 2 * m, n)
    base = torch.arange(f, device=x.device) * (2 * m) + head
    s_row = torch.where(store[:, None], s.to(hd), rows.index_select(0, base))
    y_row = torch.where(store[:, None], y.to(hd),
                        rows.index_select(0, base + m))
    rows.index_copy_(0, base, s_row)
    rows.index_copy_(0, base + m, y_row)
    rho = st.rho.scatter(1, head[:, None], torch.where(
        store, 1.0 / torch.where(store, ys, 1.0),
        st.rho.gather(1, head[:, None])[:, 0])[:, None])

    # the second full-history pass: H·[s y g] against the updated rows
    # gives S·y, Y·s, Y·y (the new Gram row and column of slot ``head``)
    # and S·g, Y·g for the next direction
    # (one matmul a frame: cuBLAS runs the batched form of this long-K GEMM
    # with a 2m × 3 output in one pass of small tiles, 25 ms a call at 4 ×
    # 512² on an H100 against 0.38 ms for one frame)
    rhs = torch.stack([s_row, y_row, g.to(hd)], 2)
    prods = torch.stack([hist[i] @ rhs[i] for i in range(f)]).float()
    s_y, sg = prods[:, :m, 1], prods[:, :m, 2]
    y_s, y_y, yg = prods[:, m:, 0], prods[:, m:, 1], prods[:, m:, 2]
    # sy[i, j] = s_iᵀ y_j: row head ← (Y·s_new), column head ← (S·y_new)
    sy = _set_col(_set_row(st.sy, head, y_s, store), head, s_y, store)
    yy = _set_col(_set_row(st.yy, head, y_y, store), head, y_y, store)

    small_grad = g.abs().amax(1) <= tolerance_grad
    small_step = s.abs().amax(1) <= tolerance_change
    small_dloss = (loss - st.loss).abs() < tolerance_change
    return LBFGSState(
        x=x, g=g, loss=loss, hist=hist, rho=rho, sy=sy, yy=yy,
        sg=sg.contiguous(), yg=yg.contiguous(),
        head=torch.where(store, (head + 1) % m, head),
        count=torch.where(store, torch.clamp(st.count + 1, max=m), st.count),
        k=st.k + 1,
        done=st.done | bad_dir | small_grad,
        pause=(small_step | small_dloss) & ~st.pause)
