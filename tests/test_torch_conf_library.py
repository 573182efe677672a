"""Every YAML under ``examples/gigaspeech/conf/`` builds with the port's
``init_model`` (cut to one encoder block), with the attention its
``selfattention_layer_type`` names; the Mamba-2 YAMLs and the causal
streaming YAML raise NotImplementedError naming their ROADMAP items."""
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
}
# what the port does not build yet, by the ROADMAP item its refusal names
REFUSED = {"mamba_att": "12a.4", "causal": "item 11"}


def test_the_library_is_complete():
    assert len(YAMLS) == 29


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_builds(path):
    with open(path) as f:
        config = yaml.safe_load(f)
    enc = config["encoder_conf"]
    enc["num_blocks"] = 1
    kind = enc["selfattention_layer_type"]
    refused = ("causal" if enc.get("causal") else
               kind if kind in REFUSED else None)
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
    if kind == "limited_rel_selfattn":
        assert attn.context_size == tuple(enc["att_context_size"])
        assert attn.global_tokens == enc["global_tokens"]
