"""Entry points run on the GPU unless the caller asks for the CPU: with no
card they raise, naming device="cpu", and never drop to the CPU quietly.
Settings the port once refused now build on the CPU."""
import pytest
import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model

SERVE = dict(max_batch=2, page_size=4, n_pages=16, max_pages_per_seq=4,
             sanitize_level="off", dispatch_sentinel=False)


@pytest.fixture
def model_and_params():
    model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def test_engine_without_device_raises_when_no_card(model_and_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(*model_and_params, ServeConfig(**SERVE))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)


def test_engine_on_cpu_when_asked(model_and_params):
    eng = Engine(*model_and_params, ServeConfig(**SERVE), device="cpu")
    assert eng.device.type == "cpu" and eng.k_pages.device.type == "cpu"


@pytest.mark.parametrize("knob", [dict(kv_dtype="int8"), dict(sanitize_level="step"),
                                  dict(dispatch_sentinel=True)])
def test_unported_settings_are_refused(model_and_params, knob):
    """int8 KV pages, the sanitizer and the dispatch sentinel are ported
    and build on the CPU."""
    serve = ServeConfig(**dict(SERVE, **knob))
    eng = Engine(*model_and_params, serve, device="cpu")
    if serve.dispatch_sentinel:
        assert eng.dispatch is not None and "decode" in eng.dispatch.report()
    elif serve.kv_dtype == "int8":
        assert eng.kv_quant is not None
        assert eng.k_pages["q"].dtype == torch.int8 and eng.k_pages["q"].device.type == "cpu"
    else:
        assert eng.sanitizer is not None
