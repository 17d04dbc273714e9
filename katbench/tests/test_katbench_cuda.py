"""The tiny cells on the card: correct, and the traced run reads the
card's events (every per-layer metric that reads the trace reports)."""

import pytest
import torch

from katbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_on_the_card(tmp_path, dev, cell):
    root = tiny.make_root(str(tmp_path))
    out = tiny.run(root, cell, trace=True, device=dev)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert {"plain_ms_per_gwin", "host_syncs_per_job", "flush_roofline",
            "device_idle_share"} <= set(m)
    assert 0 < m["flush_roofline"]["value"] <= 100
    assert out["device"]["busy_s"] > 0
