"""The port's episodic few-shot head (``heads/episodic.py``) against adfmsl's.

- Host side, on the synthetic fixture: ``group_by_class``,
  ``sample_episode_indices`` and ``EpisodeSampler`` (through each package's
  ``AsvspoofDataset.load_batch``) give adfmsl's ids and arrays bitwise, for
  several episode shapes and seeds.
- The math on seeded numpy inputs: prototypes, both logit metrics, one
  episode's and the batched loss and accuracy, K-shot adaptation and the
  prototype scores, within 1e-6 * max(1, |adfmsl's|) (the squared-distance
  logits reach 40, where f32 spacing is 4e-6).
- One episodic meta step of maze5 at full width, cut 4000, E = N = K = Q = 2,
  f32 with the randomness off, from adfmsl's initial weights carried across
  by ``state_dict_from_flax``: loss within 1e-5 relative; per-leaf gradient
  cosine >= 0.9999 for every leaf that carries more than 3e-5 of the global
  norm on either side (smaller ones are analytically zero, as
  tests/test_torch_train_step.py sets out); the global update's cosine
  >= 0.999 and its norm within 1e-3; the BN running statistics within
  1e-5 * max(1, |v|). The update is held at 0.999, not 0.9999: Adam's first
  step is about lr * sign(g), and about 1 % of each trunk conv kernel's
  elements have a gradient at f32 noise level whose sign the two backends
  round differently, each a whole lr-sized coordinate (measured 0.99970 with
  every leaf's gradient cosine at or above 0.9999).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adfmsl.data import AsvspoofDataset as JaxDataset
from adfmsl.data import parse_protocol as jax_parse_protocol
from adfmsl.heads import episodic as jep
from adfmsl.heads.fmsl import l2_normalize as jax_l2_normalize
from adfmsl_torch.config import make_experiment
from adfmsl_torch.config.base import OptimizerConfig
from adfmsl_torch.data import AsvspoofDataset, parse_protocol
from adfmsl_torch.heads import episodic as tep
from adfmsl_torch.models import build_model, state_dict_from_flax
from adfmsl_torch.train import Optimizer
from test_torch_train_step import deterministic

CUT = 4000
E = N = K = Q = 2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_group_by_class_matches_adfmsl(fixture_dir):
    path = fixture_dir["train"]["protocol"]
    assert tep.group_by_class(parse_protocol(path)) == jep.group_by_class(
        jax_parse_protocol(path))
    assert tep.group_by_class(parse_protocol(path), bonafide_as_class=False) == \
        jep.group_by_class(jax_parse_protocol(path), bonafide_as_class=False)


@pytest.mark.parametrize("n_way,k_shot,q", [(2, 1, 1), (2, 2, 2), (3, 1, 3), (4, 2, 2)])
def test_sample_episode_indices_matches_adfmsl(fixture_dir, n_way, k_shot, q):
    path = fixture_dir["train"]["protocol"]
    groups = tep.group_by_class(parse_protocol(path))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        got = tep.sample_episode_indices(a, groups, n_way, k_shot, q)
        ref = jep.sample_episode_indices(b, groups, n_way, k_shot, q)
        assert got == ref
    with pytest.raises(ValueError, match="need 10 classes"):
        tep.sample_episode_indices(a, groups, 10, 50, 50)


@pytest.mark.parametrize("n_way,k_shot,q,e,seed", [(2, 2, 2, 2, 1234), (2, 1, 3, 3, 7),
                                                   (3, 1, 1, 2, 11)])
def test_episode_sampler_matches_adfmsl(fixture_dir, n_way, k_shot, q, e, seed):
    tr = fixture_dir["train"]
    ds = AsvspoofDataset(parse_protocol(tr["protocol"]), tr["audio_dir"], cut=CUT)
    jds = JaxDataset(jax_parse_protocol(tr["protocol"]), tr["audio_dir"], cut=CUT)
    got = tep.EpisodeSampler(ds.protocol, None, n_way, k_shot, q, e, seed,
                             load_batch_fn=lambda ids: ds.load_batch(ids)[0])
    ref = jep.EpisodeSampler(jds.protocol, None, n_way, k_shot, q, e, seed,
                             load_batch_fn=lambda ids: jds.load_batch(ids)[0])
    one = tep.EpisodeSampler(ds.protocol, lambda u: ds.load(u)[0], n_way, k_shot, q,
                             e, seed)
    for _ in range(2):
        a, b, c = got.next_batch(), ref.next_batch(), one.next_batch()
        assert a.class_names == b.class_names == c.class_names
        assert a.support.shape == (e, n_way, k_shot, CUT) and a.query.shape == (e, n_way, q, CUT)
        for x, y in ((a.support, b.support), (a.query, b.query), (a.support, c.support)):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="load_fn or load_batch_fn"):
        tep.EpisodeSampler(ds.protocol)


def close(a, b):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(b).max()))


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("metric", ["cosine", "sqeuclidean"])
def test_episode_math_matches_adfmsl(metric):
    rng = np.random.default_rng(3)
    sup, qry = _unit(rng, 3, 2, 4, 16), _unit(rng, 3, 2, 5, 16)
    t = lambda a: torch.from_numpy(a)            # noqa: E731
    j = jnp.asarray
    close(tep.prototypes_from_support(t(sup[0])), jep.prototypes_from_support(j(sup[0])))
    protos = jep.prototypes_from_support(j(sup[0]))
    close(tep.prototypical_logits(t(qry[0, 0]), t(np.array(protos)), 7.0, metric),
          jep.prototypical_logits(j(qry[0, 0]), protos, 7.0, metric))
    for i in range(3):
        for a, b in zip(tep.episode_loss(t(sup[i]), t(qry[i]), 10.0, metric),
                        jep.episode_loss(j(sup[i]), j(qry[i]), 10.0, metric)):
            close(a, b)
    for a, b in zip(tep.batched_episode_loss(t(sup), t(qry), 10.0, metric),
                    jep.batched_episode_loss(j(sup), j(qry), 10.0, metric)):
        close(a, b)
    with pytest.raises(ValueError, match="unknown metric"):
        tep.prototypical_logits(t(qry[0, 0]), t(sup[0, 0]), metric="manhattan")


def test_kshot_adapt_and_scores_match_adfmsl():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    audio = rng.standard_normal((10, 64)).astype(np.float32)
    labels = np.asarray([0, 1, 1, 0, 1, 0, 0, 1, 1, 1])
    test_audio = rng.standard_normal((7, 64)).astype(np.float32)
    protos = tep.kshot_adapt(lambda x: x @ torch.from_numpy(w), torch.from_numpy(audio),
                             torch.from_numpy(labels), 2)
    ref = jep.kshot_adapt(lambda p, x: x @ p, jnp.asarray(w), jnp.asarray(audio),
                          jnp.asarray(labels), 2)
    close(protos, ref)
    s = tep.prototype_scores(lambda x: x @ torch.from_numpy(w), torch.from_numpy(test_audio),
                             protos, temperature=5.0)
    r = jep.prototype_scores(lambda p, x: x @ p, jnp.asarray(w), jnp.asarray(test_audio),
                             ref, temperature=5.0)
    close(s, r)
    # a class with no support row gives the zero vector's normalisation
    empty = tep.kshot_adapt(lambda x: x @ torch.from_numpy(w), torch.from_numpy(audio),
                            torch.zeros(10, dtype=torch.long), 2)
    assert torch.equal(empty[1], torch.zeros(8))


@pytest.fixture(scope="module")
def meta_step():
    """adfmsl's jitted episodic step and gradient on maze5, and the port's step
    from the same weights and episode batch."""
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.models import build_model as jax_build_model
    from adfmsl.train.fewshot import _step_rngs

    jexp = deterministic(jax_experiment("maze5"), "float32")
    jmodel = jax_build_model(jexp.model)
    v = jax.jit(lambda k, x: jmodel.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, CUT)))
    params, stats = v["params"], v["batch_stats"]
    rng = np.random.default_rng(8)
    sup = (0.1 * rng.standard_normal((E, N, K, CUT))).astype(np.float32)
    qry = (0.1 * rng.standard_normal((E, N, Q, CUT))).astype(np.float32)

    def embed_train(p, bs, audio, r):
        out, mut = jmodel.apply({"params": p, "batch_stats": bs}, audio, train=True,
                                rngs=_step_rngs(r), mutable=["batch_stats"])
        return out["features"], mut["batch_stats"]

    def loss_fn(p):
        flat = jnp.concatenate([jnp.asarray(sup).reshape(E, N * K, CUT),
                                jnp.asarray(qry).reshape(E, N * Q, CUT)],
                               axis=1).reshape(-1, CUT)
        emb = jax_l2_normalize(embed_train(p, stats, flat, jax.random.PRNGKey(1))[0])
        per = emb.reshape(E, N * (K + Q), -1)
        return jep.batched_episode_loss(per[:, :N * K].reshape(E, N, K, -1),
                                        per[:, N * K:].reshape(E, N, Q, -1))[0]

    ref_loss, ref_g = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    step = jep.make_episodic_train_step(None, tx, embed_train_fn=embed_train)
    new_p, _, new_stats, jm = step(params, tx.init(params), jnp.asarray(sup),
                                   jnp.asarray(qry), batch_stats=stats,
                                   rng=jax.random.PRNGKey(1))

    def port(tree_p, tree_s):
        return state_dict_from_flax(jax.tree.map(np.asarray, tree_p),
                                    jax.tree.map(np.asarray, tree_s), "maze5")

    exp = deterministic(make_experiment("maze5"), "float32")
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(port(params, stats), strict=True)
    pre = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = Optimizer(OptimizerConfig(name="adam", lr=1e-3, weight_decay=0.0,
                                    grad_clip_norm=1.0), model.parameters(), 1, 1)

    def port_embed_train(audio, rngs):
        model.train()
        return model(audio, rngs=rngs)["features"]

    met = tep.make_episodic_train_step(port_embed_train, opt)(
        torch.from_numpy(sup), torch.from_numpy(qry))
    return {"ref_loss": float(ref_loss), "jax_loss": float(jm["loss"]),
            "jax_acc": float(jm["acc"]), "ref_grads": port(ref_g, stats),
            "ref_pre": port(params, stats), "ref_post": port(new_p, new_stats),
            "loss": float(met["loss"]), "acc": float(met["acc"]), "pre": pre,
            "post": model.state_dict(), "grads": {n: p.grad.clone() for n, p in
                                                  model.named_parameters()}}


def test_meta_step_loss_and_accuracy_match_adfmsl(meta_step):
    r = meta_step
    np.testing.assert_allclose(r["loss"], r["jax_loss"], rtol=1e-5)
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-5)
    assert r["acc"] == r["jax_acc"]


def test_meta_step_gradients_match_adfmsl(meta_step):
    """The port's ``.grad`` is clipped by one global factor: per-leaf cosines
    do not see it. fc2, which the features do not reach, has zero gradients
    on both sides."""
    grads = {k: v.numpy().ravel().astype(np.float64) for k, v in meta_step["grads"].items()}
    ref = {k: v.numpy().ravel().astype(np.float64) for k, v in meta_step["ref_grads"].items()
           if k in grads}
    assert grads.keys() == ref.keys()
    assert not grads["fc2.weight"].any() and not ref["fc2.weight"].any()
    gn = max(np.sqrt(sum(v @ v for v in grads.values())), np.sqrt(sum(v @ v for v in ref.values())))
    checked = 0
    for k, b in ref.items():
        a = grads[k]
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 3e-5 * gn and nb < 3e-5 * gn:
            continue
        cos = float(a @ b / (na * nb))
        assert cos >= 0.9999, f"{k}: gradient cosine {cos:.6f}"
        checked += 1
    assert checked >= 20


def test_meta_step_update_and_statistics_match_adfmsl(meta_step):
    r = meta_step
    dot = nt = nj = 0.0
    for k, v in r["ref_pre"].items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            moved = r["post"][k].float() - r["pre"][k].float()
            ref = r["ref_post"][k]
            np.testing.assert_allclose(r["post"][k].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5 * max(1.0, float(ref.abs().max())),
                                       err_msg=k)
            if k.endswith("running_mean"):
                assert moved.abs().max() > 0, k
            continue
        dt = (r["post"][k] - r["pre"][k]).double().numpy().ravel()
        dj = (r["ref_post"][k] - v).double().numpy().ravel()
        dot, nt, nj = dot + dt @ dj, nt + dt @ dt, nj + dj @ dj
    cos = dot / np.sqrt(nt * nj)
    assert cos >= 0.999, f"global update cosine {cos:.6f}"
    np.testing.assert_allclose(np.sqrt(nt / nj), 1.0, rtol=1e-3)


def test_meta_step_order_l2_and_unreached_leaves():
    """The trunk sees support and query concatenated inside each episode,
    episode axis outermost (adfmsl :197-203); the embeddings are
    L2-normalised before the loss, so scaling them changes nothing; a
    parameter the loss does not reach gets a zero gradient and stays."""
    sup, qry = torch.randn(3, 2, 2, 12), torch.randn(3, 2, 1, 12)
    losses = []
    for scale in (1.0, 5.0):
        torch.manual_seed(0)
        lin, unused = torch.nn.Linear(12, 4), torch.nn.Linear(2, 2)
        opt = Optimizer(OptimizerConfig(name="adam", lr=1e-2, weight_decay=0.0,
                                        grad_clip_norm=1.0),
                        [*lin.parameters(), *unused.parameters()], 1, 1)
        seen = []

        def embed(x, rngs, lin=lin, scale=scale, seen=seen):
            seen.append(x)
            return scale * lin(x)

        before = unused.weight.detach().clone()
        met = tep.make_episodic_train_step(embed, opt)(sup, qry)
        want = torch.cat([sup.reshape(3, 4, 12), qry.reshape(3, 2, 12)], 1).reshape(18, 12)
        assert len(seen) == 1 and torch.equal(seen[0], want)
        assert torch.equal(unused.weight.grad, torch.zeros(2, 2))
        assert torch.equal(unused.weight, before)
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
