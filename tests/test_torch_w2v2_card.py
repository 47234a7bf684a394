"""On a card: the maze7, maze3, maze2 and maze6 folded trunks (K1, with
maze2's 768 -> 128 and maze6's 1024 -> 128 stack heads) against the unfolded
bf16 trunks, at full width (the base Wav2Vec2 encoder, maze6's large one, random
init from seed 0), cut 64600, batch 4. No JAX here, so the file runs on a machine without
it: ``python -m pytest --noconftest -q tests/test_torch_w2v2_card.py -m cuda``.
"""
import pytest
import torch

from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model


K1_LAUNCHES = {"maze7": 5, "maze3": 3, "maze2": 6, "maze6": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K1_LAUNCHES))
def test_folded_trunk_matches_unfolded_on_card(name):
    """Full width (base encoder, random init), cut 64600, batch 4: the folded
    trunk through K1 (``K1_LAUNCHES`` a forward) within 3e-2 *
    max(1, |logits|) of the unfolded bf16 trunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU form")
    from adfmsl_torch.ops import resblock_fused as rf

    models = {}
    for fused in (True, False):
        exp = make_experiment(name)
        exp.model.extra["fused_eval_trunk"] = fused
        models[fused] = build_model(exp.model, device="cuda", seed=0)
    models[False].load_state_dict(models[True].state_dict())
    g = torch.Generator(device="cuda").manual_seed(0)
    x = 0.1 * torch.randn((4, 64600), generator=g, device="cuda")
    with torch.inference_mode():
        rf.resblock_eval.launches = 0
        lf = models[True](x)["logits"].float()
        torch.cuda.synchronize()
        launches = rf.resblock_eval.launches
        lu = models[False](x)["logits"].float()
    assert launches == K1_LAUNCHES[name]
    tol = 3e-2 * max(1.0, lu.abs().max().item())
    assert (lf - lu).abs().max().item() <= tol
