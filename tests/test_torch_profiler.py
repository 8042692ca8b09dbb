"""The port's profiler (``utils/profiler.py``) on the CPU: a Chrome trace
written by ``device_trace``, with the training step's program spans in it."""

import json

import pytest
import torch

import torch_dp_workers as dpw
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step
from unsupervised_depth_opticalflow_egomotion_torch.utils.profiler import device_trace

pytestmark = pytest.mark.quick
torch.set_num_threads(2)


def test_profiler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with device_trace("unused"):
            pass


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The region's host ops and a flow step's program spans in
    ``<logdir>/trace.json``."""
    cfg = Config(img_hw=(dpw.H, dpw.W), batch_size=2, compute_dtype="float32", mode="flow",
                 flow_occ_impl="splat_nn")
    model, optimizer = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, optimizer)
    batch = tuple(torch.from_numpy(a) for a in dpw.batch(2))
    with device_trace(str(tmp_path / "trace"), device="cpu") as path:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
        step(batch, 0)
    assert path == str(tmp_path / "trace" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mm" in n for n in names)
    assert {"train_step", "train_step.forward", "net.pwc", "loss.terms",
            "train_step.optimizer"} <= names
