"""Model zoo factory of the port: get_policy(name) / get_config(name), the
JAX package's string → policy mapping (internnav_tpu/model/__init__.py,
the reference's internnav/model/__init__.py:1-62).

The port holds the InternVLA-N1 dual system and the recurrent VLN
policies CMA and Seq2Seq. The other policies (RDP, NavDP, CMA-CLIP) are
not ported yet and raise NotImplementedError (ROADMAP §1 item 6); an
unknown name raises KeyError, as in JAX. Their default configs are ported
(`configs/defaults`)."""

from __future__ import annotations

from internnav_tpu_torch.configs.model import ModelCfg

#: the policies still to port, by the names the factory takes
_UNPORTED = {
    "RDP_Policy": "RDPPolicy", "rdp": "RDPPolicy",
    "NavDP_Policy": "NavDPPolicy", "navdp": "NavDPPolicy",
    "CMA_CLIP_Policy": "CMACLIPPolicy", "cma_clip": "CMACLIPPolicy",
}


def get_policy(name: str):
    if name in ("CMA_Policy", "cma"):
        from internnav_tpu_torch.model.basemodel.cma import CMAPolicy

        return CMAPolicy
    if name in ("Seq2Seq_Policy", "seq2seq"):
        from internnav_tpu_torch.model.basemodel.seq2seq import Seq2SeqPolicy

        return Seq2SeqPolicy
    if name in ("InternVLAN1_Policy", "internvla_n1"):
        from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

        return InternVLAN1Policy
    if name in _UNPORTED:
        raise NotImplementedError(f"policy {name!r} ({_UNPORTED[name]}) is not yet ported to "
                                  "internnav_tpu_torch (ROADMAP §1 item 6)")
    raise KeyError(f"unknown policy {name!r}")


def get_config(name: str) -> ModelCfg:
    from internnav_tpu_torch.configs import defaults

    return defaults.get_model_cfg(name)
