"""Per-model default ModelCfgs.

Mirrors the reference's instantiated config modules
(internnav/configs/model/{cma,rdp,seq2seq,navdp,internvla_n1}.py).

Copy of internnav_tpu/configs/defaults/__init__.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_entry_points.py).
"""

from __future__ import annotations

from internnav_tpu_torch.configs.model import (
    CrossModalEncoderCfg,
    DiffusionPolicyCfg,
    ImageEncoderCfg,
    ImageEncoderDepthCfg,
    ImageEncoderRgbCfg,
    ModelCfg,
    ProgressMonitorCfg,
    StateEncoderCfg,
    TextEncoderCfg,
)


def cma_cfg() -> ModelCfg:
    """Reference internnav/configs/model/cma.py: bi-LSTM GloVe text,
    ResNet50 RGB (256), DDPPO ResNet50 depth (128), GRU 512."""
    return ModelCfg(
        policy_name="CMA_Policy",
        max_step=200,
        len_traj_act=4,
        text_encoder=TextEncoderCfg(
            model_name="glove-lstm", vocab_size=2504, embedding_size=50,
            rnn_hidden_size=128, bidirectional=True, final_state_only=False,
        ),
        image_encoder=ImageEncoderCfg(
            rgb=ImageEncoderRgbCfg(model_name="resnet50", output_size=256),
            depth=ImageEncoderDepthCfg(model_name="resnet50", output_size=128),
        ),
        state_encoder=StateEncoderCfg(hidden_size=512, rnn_type="GRU"),
        progress_monitor=ProgressMonitorCfg(use=True, alpha=1.0),
        num_actions=4,
    )


def seq2seq_cfg() -> ModelCfg:
    """Reference internnav/configs/model/seq2seq.py."""
    cfg = cma_cfg()
    cfg.policy_name = "Seq2Seq_Policy"
    cfg.text_encoder.final_state_only = True
    return cfg


def rdp_cfg() -> ModelCfg:
    """Reference internnav/configs/model/rdp.py: RoBERTa/LongCLIP text,
    CLIP RGB, diffusion transformer head over waypoints."""
    return ModelCfg(
        policy_name="RDP_Policy",
        max_step=200,
        len_traj_act=4,
        text_encoder=TextEncoderCfg(model_name="roberta", hidden_size=768, num_l_layers=6),
        image_encoder=ImageEncoderCfg(
            rgb=ImageEncoderRgbCfg(model_name="clip", feature_dim=768, output_size=512,
                                   projection_dim=512, img_mod="multi_patches_avg_pooling"),
            depth=ImageEncoderDepthCfg(model_name="resnet50", output_size=128),
        ),
        cross_modal_encoder=CrossModalEncoderCfg(num_x_layers=2, hidden_size=512,
                                                 num_attention_heads=8),
        state_encoder=StateEncoderCfg(hidden_size=512, rnn_type="GRU"),
        progress_monitor=ProgressMonitorCfg(use=True),
        diffusion_policy=DiffusionPolicyCfg(
            use=True, type="transformer", scheduler="ddpm",
            num_train_timesteps=20, num_inference_timesteps=20,
            n_layer=3, n_head=8, n_emb=512, horizon=8, len_traj_pred=8,
            use_cls_free_guidance=True, cls_free_guidance_scale=1.5,
            cls_mask_ratio=0.25,
        ),
        num_actions=4,
        learn_angle=True,
    )


def navdp_cfg() -> ModelCfg:
    """Reference internnav/configs/model/navdp.py: DepthAnything ViT-S
    towers, transformer-decoder denoiser, critic head."""
    cfg = ModelCfg(
        policy_name="NavDP_Policy",
        len_traj_act=24,
        diffusion_policy=DiffusionPolicyCfg(
            use=True, type="transformer", scheduler="ddpm",
            num_train_timesteps=10, num_inference_timesteps=10,
            n_emb=384, n_layer=4, n_head=8, horizon=24,
        ),
        num_actions=3,
    )
    cfg.image_size = 224
    cfg.memory_size = 8
    cfg.predict_size = 24
    cfg.temporal_depth = 8
    cfg.token_dim = 384
    return cfg


def internvla_n1_cfg() -> ModelCfg:
    """Reference internnav/configs/model/internvla_n1.py: Qwen2.5-VL S2 +
    NextDiT/NavDP S1."""
    cfg = ModelCfg(policy_name="InternVLAN1_Policy")
    cfg.system1 = "nextdit_async"
    cfg.n_query = 4
    cfg.hidden_size = 3584
    cfg.num_history = 8
    cfg.len_traj_act = 4
    return cfg


_CFGS = {
    "cma": cma_cfg,
    "CMA_Policy": cma_cfg,
    "seq2seq": seq2seq_cfg,
    "Seq2Seq_Policy": seq2seq_cfg,
    "rdp": rdp_cfg,
    "RDP_Policy": rdp_cfg,
    "navdp": navdp_cfg,
    "NavDP_Policy": navdp_cfg,
    "internvla_n1": internvla_n1_cfg,
    "InternVLAN1_Policy": internvla_n1_cfg,
}


def get_model_cfg(name: str) -> ModelCfg:
    if name not in _CFGS:
        raise KeyError(f"no default config for {name!r}; known: {sorted(_CFGS)}")
    return _CFGS[name]()
