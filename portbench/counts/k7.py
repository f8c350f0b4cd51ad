"""K7a / K7b (`resblock_int8_tiled_a` / `_b`): the operations and bytes of
one 3×3 conv over all of C each, the arithmetic of PERF.md's kernel table.
K7a reads bf16 and writes int8; K7b reads int8, the bf16 skip and writes
bf16."""

from portbench.counts.peaks import bound_s


def half_bound_s(n: int, h: int, w: int, c: int, half: str) -> float:
    """Least seconds of one K7a (``half`` "a") or K7b ("b") launch."""
    act = 2 + 1 if half == "a" else 1 + 2 + 2
    return bound_s(2.0 * n * h * w * 9 * c * c,
                   n * h * w * c * act + 9 * c * c + 4 * c * 4, "int8")
