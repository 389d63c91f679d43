"""Model configuration tree.

Mirrors the surface of the reference's pydantic model configs
(internnav/configs/model/base_encoders.py: classes at lines 6,24,36,48,57,
67,76,97,181) so checkpoints/configs written against the reference schema
validate here too, while staying backend-agnostic (all defaults are plain
python; nothing torch-specific).

Copy of internnav_tpu/configs/model.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_entry_points.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pydantic import BaseModel, ConfigDict


class _Cfg(BaseModel):
    model_config = ConfigDict(extra="allow")


class TextEncoderCfg(_Cfg):
    model_name: str = "roberta"  # roberta | clip-long | bert | glove-lstm
    hidden_size: int = 768
    num_l_layers: int = 6
    vocab_size: int = 50265
    pad_token_id: int = 1
    max_length: int = 512
    embedding_size: int = 50  # glove embedding dim
    dropout: float = 0.1
    final_state_only: bool = True
    rnn_hidden_size: int = 128
    bidirectional: bool = False
    load_model_path: Optional[str] = None


class ImageEncoderRgbCfg(_Cfg):
    model_name: str = "resnet18"  # resnet18 | resnet50 | clip | vit
    feature_dim: int = 512
    projection_dim: int = 256
    output_size: int = 256
    level: str = "high"
    update_rgb_encoder: bool = False
    img_mod: str = "cls"  # cls | multi_patches_avg_pooling
    multi_patches_num: int = 4
    load_model_path: Optional[str] = None


class ImageEncoderDepthCfg(_Cfg):
    model_name: str = "resnet50"
    feature_dim: int = 128
    projection_dim: int = 256
    output_size: int = 128
    bottleneck: str = "resnet"
    ddppo_checkpoint: Optional[str] = None
    update_depth_encoder: bool = False


class ImageEncoderCfg(_Cfg):
    rgb: ImageEncoderRgbCfg = ImageEncoderRgbCfg()
    depth: ImageEncoderDepthCfg = ImageEncoderDepthCfg()
    dropout: float = 0.1
    use_stack: bool = False
    rgb_proj_dim: int = 512
    depth_proj_dim: int = 256
    env_num: int = 1
    proc_num: int = 1


class CrossModalEncoderCfg(_Cfg):
    num_x_layers: int = 2
    hidden_size: int = 512
    num_attention_heads: int = 8
    dropout: float = 0.1


class StateEncoderCfg(_Cfg):
    hidden_size: int = 512
    rnn_type: str = "GRU"  # GRU | LSTM
    num_recurrent_layers: int = 1
    dropout: float = 0.1


class ProgressMonitorCfg(_Cfg):
    use: bool = True
    alpha: float = 1.0
    concat_state_txt: bool = True


class DistancePredictorCfg(_Cfg):
    """Aux distance-to-goal head (reference rdp_policy.py:267-272,643-647;
    off in the shipped rdp_cfg but supported)."""

    use: bool = False
    normalize: bool = False


class ImuEncoderCfg(_Cfg):
    use: bool = False
    input_size: int = 4
    encoding_size: int = 64
    to_local_coords: bool = True


class PrevActionEncoderCfg(_Cfg):
    use: bool = False
    input_size: int = 4
    encoding_size: int = 64


class DiffusionPolicyCfg(_Cfg):
    use: bool = False
    type: str = "transformer"  # transformer | unet
    scheduler: str = "ddpm"  # ddpm | flow_match
    num_train_timesteps: int = 100
    num_inference_timesteps: int = 10
    beta_schedule: str = "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # epsilon | sample | v_prediction
    clip_sample: bool = True
    action_stats: Optional[Dict[str, Any]] = None
    n_layer: int = 6
    n_head: int = 8
    n_emb: int = 512
    horizon: int = 8  # predicted waypoints (len_traj_act)
    n_obs_steps: int = 2
    causal_attn: bool = True
    use_cls_free_guidance: bool = False
    cls_free_guidance_scale: float = 1.5
    cls_mask_ratio: float = 0.1
    random_mask_instr: bool = True
    transformer_encoder_layers: int = 0
    waypoint_spacing: int = 1
    len_traj_pred: int = 8
    learn_angle: bool = True
    metric_waypoint_spacing: float = 1.0


class StatePredictorCfg(_Cfg):
    use: bool = False
    hidden_size: int = 512
    num_waypoints: int = 8


class BertCfg(_Cfg):
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    vocab_size: int = 30522


class ModelCfg(_Cfg):
    """Aggregate model config (reference: base_encoders.py:181)."""

    policy_name: Optional[str] = None
    model_path: Optional[str] = None
    ckpt_to_load: Optional[str] = None

    text_encoder: TextEncoderCfg = TextEncoderCfg()
    image_encoder: ImageEncoderCfg = ImageEncoderCfg()
    cross_modal_encoder: Optional[CrossModalEncoderCfg] = None
    state_encoder: StateEncoderCfg = StateEncoderCfg()
    progress_monitor: ProgressMonitorCfg = ProgressMonitorCfg()
    distance_predictor: Optional[DistancePredictorCfg] = None
    imu_encoder: Optional[ImuEncoderCfg] = None
    prev_action_encoder: Optional[PrevActionEncoderCfg] = None
    diffusion_policy: Optional[DiffusionPolicyCfg] = None
    state_predictor: Optional[StatePredictorCfg] = None
    bert: Optional[BertCfg] = None

    # action space
    num_actions: int = 4
    max_step: int = 200
    len_traj_act: int = 8

    # learning-side knobs carried on the model cfg in the reference
    learn_angle: bool = True
    normalize_rgb: bool = True
    seq_mode: bool = False
    dropout: float = 0.1

    # dtype policy for TPU: compute in bf16, params/accum in f32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
