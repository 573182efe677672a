"""Every YAML under ``examples/gigaspeech/conf/`` builds with the port's
``init_model`` (cut to one encoder block), with the attention its
``selfattention_layer_type`` names (the Mamba-2 YAMLs with their direction,
the causal streaming YAML with a causal conv module); nothing is refused."""
import glob
import os

import pytest
import torch
import yaml

from paper_accurate_fast_cheap_tpu_torch.models import factory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "examples", "gigaspeech",
                                      "conf", "*.yaml")))
# attention module class by selfattention_layer_type
CLASSES = {
    "rel_selfattn": "RelPositionMultiHeadedAttention",
    "limited_rel_selfattn": "LimitedRelPositionAttention",
    "mamba_att": "MambaAttention",
}
# what the port does not build yet, by the ROADMAP item its refusal names
REFUSED = {}


def test_the_library_is_complete():
    assert len(YAMLS) == 29


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_builds(path):
    with open(path) as f:
        config = yaml.safe_load(f)
    enc = config["encoder_conf"]
    enc["num_blocks"] = 1
    kind = enc["selfattention_layer_type"]
    refused = next((k for k in REFUSED if k == kind or enc.get(k)), None)
    if refused:
        with pytest.raises(NotImplementedError, match=REFUSED[refused]):
            factory.init_model(config, 40, 80, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        return
    model, kind_built = factory.init_model(
        config, 40, 80, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert kind_built == config.get("model", "asr_model")
    attn = getattr(model.encoder, model.encoder.attention_names[0])
    assert type(attn).__name__ == CLASSES.get(kind, "RWKVAttention")
    assert model.encoder.layer_0.conv_module.causal == bool(
        enc.get("causal", False))
    if kind == "mamba_att":
        assert attn.direction == enc["rnn_att_direction"]
        assert attn.mamba_fwd.nheads == 2 * enc["output_size"] // (
            enc["output_size"] // enc["attention_heads"])
    if kind == "limited_rel_selfattn":
        assert attn.context_size == tuple(enc["att_context_size"])
        assert attn.global_tokens == enc["global_tokens"]
