"""The HF tokenizer of a checkpoint directory in the port.

`load_hf_tokenizer` is the JAX package's (its `SPECIALS` map), and the
port's prompt builder gives, with it, the same ids as the JAX policy's and
as `transformers`' `apply_chat_template` on the reference's conversation
(the local tiny Qwen2 tokenizer fixture of tests/test_hf_tokenizer_parity.py,
no hub). A checkpoint directory with tokenizer files loads them; one whose
files do not load raises (the JAX policy falls back to its hash
`SimpleTokenizer` there, ROADMAP §3); one without tokenizer files gets
`SimpleTokenizer`, as in the JAX package.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu.model.utils.tokenization import load_hf_tokenizer as jax_load_hf_tokenizer
from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
    InternVLAN1Policy,
    SimpleTokenizer,
    checkpoint_tokenizer,
)
from internnav_tpu_torch.model.utils.tokenization import load_hf_tokenizer
from internnav_tpu_torch.model.weights import safetensors_io as sio
from internnav_tpu_torch.model.weights.convert import hf_state_dict
from test_hf_tokenizer_parity import (  # noqa: F401 (a fixture)
    _reference_conversation,
    qwen_tokenizer_dir,
)

torch.set_num_threads(2)
INSTRUCTION = "walk to the kitchen, then turn left and stop near the sofa"


@pytest.fixture(scope="module")
def policy():
    return InternVLAN1Policy.build(InternVLAN1Config.tiny(), device="cpu")


def test_specials_equal_jax(qwen_tokenizer_dir):
    tok = load_hf_tokenizer(qwen_tokenizer_dir)
    assert tok.SPECIALS == jax_load_hf_tokenizer(qwen_tokenizer_dir).SPECIALS
    assert tok.SPECIALS["<|im_start|>"] >= 256 and len(tok.SPECIALS) == 6
    assert tok.eos_token_id == tok.SPECIALS["<|im_end|>"] and tok.pad_token_id is not None


@pytest.mark.parametrize("n_history", [0, 3, 8])
def test_prompt_ids_equal_jax_and_the_chat_template(qwen_tokenizer_dir, policy, n_history):
    tok = load_hf_tokenizer(qwen_tokenizer_dir)
    policy.tokenizer = tok
    hw = (28, 28)  # one merged token an image
    got = policy._build_prompt_ids(INSTRUCTION, n_history + 1, hw)[0]
    jtok = jax_load_hf_tokenizer(qwen_tokenizer_dir)
    jpol = JPolicy.__new__(JPolicy)
    jpol.tokenizer, jpol.cfg = jtok, policy.cfg
    want = JPolicy._build_prompt_ids(jpol, INSTRUCTION, n_history + 1, hw)[0]
    np.testing.assert_array_equal(got, np.asarray(want))
    template = tok.apply_chat_template(_reference_conversation(INSTRUCTION, n_history),
                                       tokenize=True, add_generation_prompt=True)
    np.testing.assert_array_equal(got, np.asarray(template))


def test_checkpoint_directories_choose_their_tokenizer(qwen_tokenizer_dir, tmp_path):
    cfg = InternVLAN1Config.tiny()
    sd = hf_state_dict(InternVLAN1Policy.build(cfg, device="cpu").model)
    plain = tmp_path / "plain"
    plain.mkdir()
    sio.write_safetensors(str(plain / "model.safetensors"), sd)
    assert isinstance(checkpoint_tokenizer(str(plain), 512), SimpleTokenizer)
    pol = InternVLAN1Policy.from_pretrained_torch(str(plain), cfg, device="cpu")
    assert isinstance(pol.tokenizer, SimpleTokenizer)

    with_tok = tmp_path / "with_tokenizer"
    with_tok.mkdir()
    sio.write_safetensors(str(with_tok / "model.safetensors"), sd)
    for f in ("vocab.json", "merges.txt", "tokenizer_config.json"):
        shutil.copy(f"{qwen_tokenizer_dir}/{f}", with_tok / f)
    pol = InternVLAN1Policy.from_pretrained_torch(str(with_tok), cfg, device="cpu")
    assert pol.tokenizer.SPECIALS == load_hf_tokenizer(qwen_tokenizer_dir).SPECIALS
    pol.save_pretrained(str(tmp_path / "native"))  # no tokenizer files written
    assert isinstance(InternVLAN1Policy.from_pretrained(str(tmp_path / "native"), cfg,
                                                        device="cpu").tokenizer, SimpleTokenizer)

    broken = tmp_path / "broken"
    broken.mkdir()
    sio.write_safetensors(str(broken / "model.safetensors"), sd)
    # a BPE tokenizer named without its vocab.json / merges.txt
    (broken / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "Qwen2Tokenizer", "model_max_length": 8}))
    with pytest.raises(TypeError):
        InternVLAN1Policy.from_pretrained_torch(str(broken), cfg, device="cpu")
