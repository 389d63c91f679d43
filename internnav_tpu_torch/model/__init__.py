"""Model zoo factory of the port: get_policy(name) / get_config(name), the
JAX package's string → policy mapping (internnav_tpu/model/__init__.py,
the reference's internnav/model/__init__.py:1-62).

The port holds every policy of the JAX package: the InternVLA-N1 dual
system, the recurrent VLN policies CMA and Seq2Seq, the RDP family (RDP,
CMA-CLIP) and the standalone NavDP. An unknown name raises KeyError, as in
JAX. Every default config is ported (`configs/defaults`)."""

from __future__ import annotations

from internnav_tpu_torch.configs.model import ModelCfg

def get_policy(name: str):
    if name in ("CMA_Policy", "cma"):
        from internnav_tpu_torch.model.basemodel.cma import CMAPolicy

        return CMAPolicy
    if name in ("Seq2Seq_Policy", "seq2seq"):
        from internnav_tpu_torch.model.basemodel.seq2seq import Seq2SeqPolicy

        return Seq2SeqPolicy
    if name in ("RDP_Policy", "rdp"):
        from internnav_tpu_torch.model.basemodel.rdp import RDPPolicy

        return RDPPolicy
    if name in ("CMA_CLIP_Policy", "cma_clip"):
        from internnav_tpu_torch.model.basemodel.cma_clip import CMACLIPPolicy

        return CMACLIPPolicy
    if name in ("InternVLAN1_Policy", "internvla_n1"):
        from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy

        return InternVLAN1Policy
    if name in ("NavDP_Policy", "navdp"):
        from internnav_tpu_torch.model.basemodel.navdp import NavDPPolicy

        return NavDPPolicy
    raise KeyError(f"unknown policy {name!r}")


def get_config(name: str) -> ModelCfg:
    from internnav_tpu_torch.configs import defaults

    return defaults.get_model_cfg(name)
