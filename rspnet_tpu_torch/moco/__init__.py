"""SSL task layer: MoCo with dual pretext heads (A-VID + RSP)."""
from .step import (METRIC_KEYS, MoCoConfig, MoCoState, diff_speed_gather,
                   eval_step, init_moco_state, momentum_update, queue_update,
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
    )
    model = MultiTaskWrapper(factory(dtype=dtype),
                             num_classes=moco_cfg.dim,
                             fc_type=moco_cfg.fc_type, dtype=dtype)
    return model, moco_cfg


__all__ = ["MultiTaskWrapper", "MoCoConfig", "MoCoState", "METRIC_KEYS",
           "build_moco_model", "init_moco_state", "train_step", "eval_step",
           "momentum_update", "queue_update", "diff_speed_gather"]
