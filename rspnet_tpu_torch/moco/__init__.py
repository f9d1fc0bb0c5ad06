"""SSL task layer: MoCo with dual pretext heads (A-VID + RSP)."""
from .sharded_queue import (data_model_layout, gather_queue_2d, layout_for,
                            shard_queue_2d)
from .step import (METRIC_KEYS, SINGLE, MoCoConfig, MoCoState, StepLayout,
                   data_parallel_layout, diff_speed_gather, eval_step,
                   init_moco_state, momentum_update, packed_frame_subset,
                   queue_update, speed_branch_config, speed_index_sets,
                   train_step)
from .wrapper import MultiTaskWrapper


def build_moco_model(cfg, dtype=None):
    """ConfigTree -> (MultiTaskWrapper, MoCoConfig) (port of
    rspnet_tpu/moco/__init__.py:build_moco_model); ``dtype`` is the compute
    dtype of the backbone and the heads (None: the input's)."""
    from ..models import get_model_class

    # every model.* key goes to the backbone's constructor, as in
    # rspnet_tpu/moco/__init__.py:23-29 (tsm-r18's base_model and
    # num_segments); a key the arch does not read raises
    model_cfg = cfg.get_config("model").as_plain_dict()
    factory = get_model_class(model_cfg.pop("arch"), **model_cfg)
    if not cfg.get_list("moco.diff_speed"):
        raise ValueError("moco.diff_speed must be a non-empty list (e.g. [2])")
    moco_cfg = MoCoConfig(
        dim=cfg.get_int("moco.dim"),
        k=cfg.get_int("moco.k"),
        m=cfg.get_float("moco.m"),
        t=cfg.get_float("moco.t"),
        diff_speed=tuple(cfg.get_list("moco.diff_speed")),
        fc_type=cfg.get_string("moco.fc_type", "linear"),
        loss_lambda_a=cfg.get_float("loss_lambda.A", 1.0),
        loss_lambda_m=cfg.get_float("loss_lambda.M", 1.0),
        packed_frames=cfg.get_bool("moco.packed_frames", False),
        t_load=(int(cfg.get("temporal_transforms.size"))
                if cfg.get("temporal_transforms.size", None) is not None
                else None),
    )
    model = MultiTaskWrapper(factory(dtype=dtype),
                             num_classes=moco_cfg.dim,
                             fc_type=moco_cfg.fc_type, dtype=dtype)
    return model, moco_cfg


__all__ = ["MultiTaskWrapper", "MoCoConfig", "MoCoState", "METRIC_KEYS",
           "SINGLE", "StepLayout", "build_moco_model", "data_model_layout",
           "data_parallel_layout", "diff_speed_gather", "eval_step",
           "gather_queue_2d", "init_moco_state", "layout_for",
           "momentum_update", "packed_frame_subset", "queue_update",
           "shard_queue_2d", "speed_branch_config", "speed_index_sets",
           "train_step"]
