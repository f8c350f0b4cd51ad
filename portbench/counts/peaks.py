"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
tensor-core rates without sparsity, at the 700 W power limit) and the
least time of a piece of work under them."""

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """Least seconds for ``ops`` operations at ``dtype``'s peak that move
    ``nbytes`` bytes: the larger of the two times."""
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)


def conv_flops(n: int, hout: int, wout: int, cin: int, cout: int,
               k: int) -> float:
    """2 × the multiply-adds of a k×k convolution, counted at its
    output."""
    return 2.0 * n * hout * wout * cin * cout * k * k


def convt_flops(n: int, hin: int, win: int, cin: int, cout: int,
                k: int) -> float:
    """2 × the multiply-adds of a k×k transposed convolution, counted at
    its input (each input pixel feeds k² taps of every output channel)."""
    return 2.0 * n * hin * win * cin * cout * k * k


def least_s(convs) -> float:
    """Σ flops / peak of the dtype each conv runs in, for ``(flops,
    dtype)`` pairs."""
    return sum(f / PEAK_OPS[dt] for f, dt in convs)
