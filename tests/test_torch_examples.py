"""The torch examples (``examples/torch_*.py``) on the CPU at their
smallest sizes, each through the function its figures come from:

* ``torch_quickstart``: on the reference's W and X (drawn with
  ``jax.random`` as its quickstart draws them, passed as numpy), the
  GPTVQ and RTN layer errors within 2% of the reference's functions'
  (the sweep's tolerance) at one reduced config in both packages, the
  packed payload at the paper's bits and the packed matmul close to x W^T;
* ``torch_train_tiny``: the supervised loop survives its injected failure
  (one restart, every step done, finite losses);
* ``torch_quantize_and_serve``: train, quantize, mixed recipe, the three
  serving passes (the gather and fused passes' greedy tokens identical),
  quantized KV pages, prefix sharing with identical forks, and the
  ``--family`` quantize;
* ``torch_elastic_remesh``: 4 gloo ranks under torchrun, the plans the
  reference's, the values preserved across the re-mesh.
"""
import importlib.util
import math

import jax
import numpy as np
import pytest
import torch

import ranks
from repro.core import hessian as jhes
from repro.core.bpv import VQConfig as JVQConfig
from repro.core.gptvq import gptvq_quantize_matrix as j_gptvq
from repro.core.gptvq import layer_error as j_layer_error
from repro.core.quant import rtn_quantize as j_rtn
from repro.runtime import elastic as jelastic
from repro_torch.core.bpv import VQConfig

EXAMPLES = ranks.ROOT / "examples"
SMALL = dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10,
             codebook_update_iters=5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as the other port files run under xdist: the
    examples' training and quantize loops otherwise take every core of
    each worker and crawl when six workers share them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_quickstart():
    """The reference quickstart's W and X and its functions' errors, as
    numpy, at ``SMALL``."""
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    W = jax.random.normal(k1, (256, 512))
    X = jax.random.normal(k2, (4096, 512))
    X = X.at[:, :64].mul(4.0)
    H = jhes.finalize(jhes.accumulate(jhes.init_hessian(512), X))
    U = jhes.inv_hessian_cholesky(H)
    res = j_gptvq(W, U, JVQConfig(**SMALL))
    Q_rtn = j_rtn(W, bits=2, group_size=64)
    return {"W": np.array(W), "X": np.array(X),
            "gptvq": float(j_layer_error(W, res.arrays.Q, H)),
            "rtn": float(j_layer_error(W, Q_rtn, H))}


def test_quickstart_errors_match_reference(reference_quickstart):
    ex = load("torch_quickstart")
    ref = reference_quickstart
    fig = ex.run(torch.from_numpy(ref["W"]), torch.from_numpy(ref["X"]),
                 VQConfig(**SMALL))
    assert fig["gptvq_layer_error"] == pytest.approx(ref["gptvq"], rel=0.02)
    assert fig["rtn_layer_error"] == pytest.approx(ref["rtn"], rel=0.02)
    assert fig["gptvq_layer_error"] < fig["rtn_layer_error"]
    assert fig["bits_per_value"] == 2.25
    assert 2.25 <= fig["payload_bits_per_value"] < 2.4
    assert 0 < fig["matmul_rel_err"] < 0.5


def test_quickstart_on_its_own_inputs():
    ex = load("torch_quickstart")
    fig = ex.run(*ex.inputs("cpu"), VQConfig(**SMALL))
    assert fig["gptvq_layer_error"] < fig["rtn_layer_error"]


def test_train_tiny_survives_a_failure():
    ex = load("torch_train_tiny")
    fig = ex.run("cpu", steps=24, fail_at=12, log=lambda *_: None)
    assert fig["steps_done"] == 24 and fig["restarts"] == 1
    assert all(math.isfinite(v) for v in fig["losses"].values())
    assert fig["losses"][20] < fig["losses"][0]


def test_quantize_and_serve_smallest():
    ex = load("torch_quantize_and_serve")
    fig = ex.run("cpu", steps=4, d_model=64, family="ssm", em_iters=4,
                 update_iters=2, log=lambda *_: None)
    assert fig["bits_per_value"] == 2.25
    assert math.isfinite(fig["ppl_fp"]) and math.isfinite(fig["ppl_vq"])
    serve = fig["serve"]
    assert set(serve) == {"fp32", "gptvq-packed", "gptvq-fused"}
    assert all(s["tokens"] == 96 for s in serve.values())
    assert serve["gptvq-packed"]["sample"] == serve["gptvq-fused"]["sample"]
    assert fig["kv_pages"]["headroom"] > 1
    assert fig["prefix"]["prefix_hits"] > 0 and fig["forks_identical"]
    assert fig["family"]["family"] == "ssm"


def test_elastic_remesh_on_ranks():
    ex = load("torch_elastic_remesh")
    fig = ex.main(["--device", "cpu", "--ranks", "4"])
    plan = jelastic.plan_mesh(4, model_parallel=2, pods=1)
    plan2 = jelastic.degrade_plan(plan, 2)
    assert fig["world"] == 4
    assert fig["plan"] == plan.__dict__ and fig["degraded"] == plan2.__dict__
    assert fig["values_preserved"]
    assert fig["local_shape"] == [4, 4] and fig["new_local_shape"] == [8, 4]
