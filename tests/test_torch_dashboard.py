"""The port's live dashboard (``cistar_tpu_torch/utils/dashboard.py``,
``apps/dashboard.py``) against the JAX package's, on logs that the port's
``MetricsLogger`` wrote; its HTTP endpoints on an ephemeral port of
127.0.0.1.
"""

import json
import math
import os
import urllib.error
import urllib.request

import pytest
import torch

from cistar_tpu.utils import dashboard as jdash
from cistar_tpu_torch.apps import dashboard as app
from cistar_tpu_torch.utils import dashboard as tdash
from cistar_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_logs(d, epochs=2, steps=6, log_every=2):
    """Two epochs of a port trainer's logs: device-tensor losses, one of
    them missing from the first epoch's steps, one step's loss NaN."""
    logger = MetricsLogger(d, n_epochs=epochs, batches_per_epoch=steps,
                           log_every=log_every)
    for e in range(epochs):
        for i in range(steps):
            losses = {"G_GAN": torch.tensor(1.0 - 0.05 * i),
                      "D_real": torch.tensor(0.5 + 0.01 * e)}
            if e == 1:
                losses["G_VGG"] = torch.tensor(
                    float("nan") if i == 3 else 0.2 * i)
            logger.log(losses, n_images=1)
        logger.end_epoch()


@pytest.mark.parametrize("log", ["live_log.jsonl", "loss_log.jsonl"])
def test_parse_history_matches_jax(tmp_path, log):
    _train_logs(str(tmp_path))
    if log == "loss_log.jsonl":   # the per-epoch fallback
        os.remove(tmp_path / "live_log.jsonl")
    got, want = (m.parse_history(str(tmp_path)) for m in (tdash, jdash))
    assert json.dumps(tdash._sanitize(got), sort_keys=True) == \
        json.dumps(jdash._sanitize(want), sort_keys=True)
    assert got["per_epoch"] == (log == "loss_log.jsonl")
    assert {"G_GAN", "D_real", "G_VGG"} <= set(got["series"])
    n = 2 if log == "loss_log.jsonl" else 6
    assert len(got["x"]) == n and got["series"]["G_VGG"][0] is None


def test_parse_history_downsamples_and_skips_torn_lines(tmp_path):
    with open(tmp_path / "live_log.jsonl", "w") as f:
        for i in range(4500):
            f.write(json.dumps({"epoch": 1, "batch": i, "loss": i}) + "\n")
        f.write("{torn")
    got, want = (m.parse_history(str(tmp_path)) for m in (tdash, jdash))
    assert got == want and len(got["x"]) == 1500


def test_http_endpoints(tmp_path):
    _train_logs(str(tmp_path))
    (tmp_path / "web" / "images").mkdir(parents=True)
    (tmp_path / "web" / "images" / "epoch001.png").write_bytes(
        b"\x89PNG\r\n")
    (tmp_path / "latest_net_G.npz").write_bytes(b"PK")
    dash = tdash.LiveDashboard(str(tmp_path), port=0,
                               host="127.0.0.1").start()
    try:
        base = f"http://127.0.0.1:{dash.port}"
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "loss curves" in page and tmp_path.name in page
        data = json.loads(urllib.request.urlopen(base + "/data").read())
        assert data["images"] == [os.path.join("web", "images",
                                               "epoch001.png")]
        nan_step = data["series"]["G_VGG"]
        assert len(nan_step) == 6 and nan_step[:3] == [None] * 3
        assert all(v is None or math.isfinite(v) for v in nan_step)
        img = urllib.request.urlopen(
            base + "/images/web/images/epoch001.png").read()
        assert img.startswith(b"\x89PNG")
        # traversal, non-images and unknown paths are 404
        for path in ("/images/../../etc/passwd", "/images/latest_net_G.npz",
                     "/nothing"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path)
            assert e.value.code == 404
    finally:
        dash.stop()


def test_app_serves_the_dir(tmp_path, monkeypatch):
    served = {}

    def fake_serve(self):
        served.update(dir=self.server.RequestHandlerClass.exp_dir,
                      port=self.port)
        self.server.server_close()

    monkeypatch.setattr(tdash.LiveDashboard, "serve_forever", fake_serve)
    app.main(["--dir", str(tmp_path), "--port", "0", "--host", "127.0.0.1"])
    assert served["dir"] == str(tmp_path) and served["port"] > 0
