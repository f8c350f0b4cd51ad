"""The fine stream's device time a call: the ms of device work launched
inside the program's ``g.enhance`` span and the spans under it (the
enhancers and the head of `netG local`), over the traced window's calls,
as the cell's traffic module reads it off the recorded spans
(``rec["trace"]["spans"]["readings"]``). None where the run recorded no
such span."""

LAYER, UNIT, SOURCE, MOVES = "generator", "ms", "program_span", \
    "infer_img_s"
KEY = "enhance_ms.infer"


def read(rec):
    tr = rec.get("trace") or {}
    return ((tr.get("spans") or {}).get("readings") or {}).get(KEY)
