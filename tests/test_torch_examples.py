"""The examples' twins (``repro_torch.examples``) on the CPU at their
smallest flags: ``serve_guided`` serves the facade at three fractions and
the continuous engine, its pass counts falling with the fraction as the
paper's arithmetic says; ``train_lm`` takes its steps to a finite loss;
``window_sweep``'s contact sheet is a binary PPM of its tiles. (Their
imports and their CUDA default are ``test_torch_hygiene.py``'s.)"""

import numpy as np
import pytest
import torch

from repro_torch.examples import serve_guided, train_lm, window_sweep


@pytest.fixture
def one_thread():
    """Tiny ops run fastest on one torch thread, and steadiest beside the
    other test workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_guided_runs_on_the_cpu(capsys, one_thread):
    out = serve_guided.main(["--device", "cpu", "--n", "1"])
    passes = {f: p for f, (_, p) in out["fractions"].items()}
    # 24 tokens: FULL steps cost 2 passes, COND steps 1
    assert passes == {0.0: 24 * 2, 0.2: 24 * 2 - 5, 0.5: 24 * 2 - 12}
    assert out["continuous"]["completed"] == 1 and out["continuous"]["passes_saved"] > 0
    assert "guidance savings" in capsys.readouterr().out


def test_train_lm_runs_on_the_cpu(one_thread):
    torch.manual_seed(0)
    hist = train_lm.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert len(hist) >= 1 and all(np.isfinite(h["loss"]) for h in hist)


def test_window_sweep_writes_a_ppm(tmp_path):
    lat = torch.linspace(-1, 1, 8 * 8 * 4).reshape(8, 8, 4)
    tiles = [window_sweep.to_img(lat), window_sweep.to_img(-lat)]
    assert tiles[0].shape == (96, 96, 3) and tiles[0].dtype == np.uint8
    path = str(tmp_path / "s.ppm")
    sheet = window_sweep.sheet(tiles, path)
    data = open(path, "rb").read()
    header = b"P6\n192 96\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 192 * 96 * 3
    np.testing.assert_array_equal(np.frombuffer(data[len(header):], np.uint8).reshape(96, 192, 3),
                                  sheet)
