"""Serve the live training dashboard for an experiment directory
(counterpart of ``cistar_tpu/apps/dashboard.py``).

The visdom-server role (``python -m visdom.server`` + ``CycleGAN/utils.py``
Logger): point it at a ``checkpoints_dir/name`` experiment dir while a train
CLI runs, port-forward, and watch losses, throughput and images live.

  python -m cistar_tpu_torch.apps.dashboard --dir checkpoints/r2l_MSRB_7 \
      [--port 8097]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="experiment directory "
                    "(checkpoints_dir/name) holding live_log.jsonl")
    ap.add_argument("--port", type=int, default=8097,
                    help="port to serve on (visdom default)")
    ap.add_argument("--host", default="0.0.0.0")
    args = ap.parse_args(argv)

    from cistar_tpu_torch.utils.dashboard import LiveDashboard

    LiveDashboard(args.dir, args.port, args.host).serve_forever()


if __name__ == "__main__":
    main()
