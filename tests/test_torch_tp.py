"""Tensor parallelism of the port's Wav2Vec2 encoder
(``adfmsl_torch/parallel/tp.py``) against adfmsl's (``adfmsl/parallel/tp.py``).

- The split rules: q / k / v weights and biases on dim 0 (heads), ``out``'s
  weight on dim 1 with its bias whole, ``intermediate_dense`` on dim 0,
  ``output_dense``'s weight on dim 1 with its bias whole, inside the
  ``wav2vec2`` encoder only; as many split leaves as adfmsl's specs have.
- maze7 on the 'tiny' encoder (2 heads), f32, cut 3200, batch 4, from
  adfmsl's initial weights (``state_dict_from_flax``): the forward split over
  2 spawned gloo ranks (one head each; CPU, 300 s limit) against adfmsl's
  single-device forward at ``tests/test_tp.py``'s atol 1e-3.
- A 2 dp x 2 tp train step on 4 ranks (the encoder unfrozen, so its split
  layers train) against the port's one-process step on the same global
  batch: the loss within 1e-5 relative, the global update cosine >= 0.99 and
  its magnitude within 2 % (``tests/test_torch_train_step.py``'s f32
  bounds), every rank's gathered parameters equal.
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model, state_dict_from_flax
from adfmsl_torch.parallel import launch
from adfmsl_torch.parallel.tp import param_spec, w2v2_param_specs
from adfmsl_torch.train import Optimizer, TrainState, make_train_step
import torch_rank_workers as W

CUT = 3200


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _exp():
    exp = W.deterministic(make_experiment("maze7"), cut=CUT)
    exp.model.wav2vec2.model_name = "tiny"
    exp.model.wav2vec2.freeze = False
    return exp


@pytest.fixture(scope="module")
def adfmsl_maze7():
    """adfmsl's maze7 on the 'tiny' encoder at f32: its initial weights in the
    port's layout and its single-device logits."""
    import jax
    import jax.numpy as jnp

    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.models import build_model as jax_build_model

    exp = jax_experiment("maze7")
    exp.model.wav2vec2.model_name = "tiny"
    exp.model.dtype = "float32"
    exp.data.cut = CUT
    model = jax_build_model(exp.model)
    v = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((4, CUT)), train=False)
    x = np.random.default_rng(0).standard_normal((4, CUT)).astype(np.float32)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False)["logits"])
    sd = state_dict_from_flax(jax.tree.map(np.asarray, v["params"]),
                              jax.tree.map(np.asarray, v.get("batch_stats", {})), "maze7")
    return sd, x, ref, v["params"]


def test_w2v2_param_specs_structure(adfmsl_maze7):
    from adfmsl.parallel import w2v2_param_specs as jax_specs

    import jax

    specs = w2v2_param_specs(build_model(_exp().model, device="cpu"))
    base = "wav2vec2.layers_0."
    assert specs[base + "attention.query.weight"] == 0
    assert specs[base + "attention.value.bias"] == 0
    assert specs[base + "attention.out.weight"] == 1
    assert specs[base + "attention.out.bias"] is None
    assert specs[base + "intermediate_dense.weight"] == 0
    assert specs[base + "intermediate_dense.bias"] == 0
    assert specs[base + "output_dense.weight"] == 1
    assert specs[base + "output_dense.bias"] is None
    assert specs[base + "layer_norm.weight"] is None and specs["fc2.weight"] is None
    assert param_spec("blocks.attention.query.weight") is None
    ref = jax.tree_util.tree_leaves(jax_specs(adfmsl_maze7[3]),
                                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert sum(1 for s in ref if len(s)) == sum(d is not None for d in specs.values())


def test_tp_forward_matches_adfmsl(adfmsl_maze7):
    sd, x, ref, _ = adfmsl_maze7
    out = launch(W.tp_run, 2, ("maze7", "tiny", sd, x, np.zeros(4, np.int32), 2, 0),
                 backend="gloo", device="cpu", timeout=W.LIMIT)
    for o in out:
        assert o["local_heads"] == 1
        np.testing.assert_allclose(o["logits"].numpy(), ref, rtol=0, atol=1e-3)


def test_dp_tp_train_step_matches_one_process_step(adfmsl_maze7):
    sd, x, _, _ = adfmsl_maze7
    y = np.array([0, 1, 1, 0], np.int32)
    exp = _exp()
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(sd, strict=True)
    st = TrainState(model, Optimizer.for_model(exp, model, 10), seed=0)
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.ones(4, dtype=torch.bool), st.generators(0, 0))
    post = model.state_dict()
    out = launch(W.tp_run, 4, ("maze7", "tiny", sd, x, y, 2, 1), backend="gloo",
                 device="cpu", timeout=W.LIMIT)
    keys = [k for k, v in post.items() if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))]
    ref = torch.cat([(post[k] - sd[k]).double().flatten() for k in keys])
    for o in out:
        np.testing.assert_allclose(o["loss"][0], float(met["loss"]), rtol=1e-5)
        for k in post:
            assert torch.equal(o["state_dict"][k], out[0]["state_dict"][k]), k
        got = torch.cat([(o["state_dict"][k] - sd[k]).double().flatten() for k in keys])
        cos = float(got @ ref / (got.norm() * ref.norm()))
        assert cos >= 0.99 and abs(float(got.norm() / ref.norm()) - 1.0) <= 0.02, cos
