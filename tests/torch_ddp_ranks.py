"""The rank side of the two-rank tests (tests/test_torch_ddp*.py).

``run_ranks(job, data)`` starts two processes (``spawn``, so each imports
torch and the port only), each joins one gloo group on a free port through
the port's ``init_distributed`` (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and runs ``JOBS[job](data, rank)``; the inputs and the
results travel through shared memory, not files. A rank takes its rows
[rB, (r+1)B) of every global array in ``data`` and the per-replica draws
(``perms``) that the test took from the JAX side.
"""
from __future__ import annotations

import os
import queue as queue_mod
import traceback

import torch


def _entry(job, data, rank, n, port, results, done):
    from rspnet_tpu_torch.parallel import init_distributed
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        init_distributed("cpu")
        results.put((rank, JOBS[job](data, rank)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    # the parent maps this rank's shared tensors before it exits
    done.wait(60)


def run_ranks(job: str, data: dict, n: int = 2,
              timeout: float = 240.0) -> list:
    """Each rank's result of ``JOBS[job]``, in rank order; a failing rank
    raises here with its traceback."""
    import torch.multiprocessing as mp
    from rspnet_tpu_torch.parallel.launch import free_port

    ctx = mp.get_context("spawn")
    results, done = ctx.Queue(), ctx.Event()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(job, data, r, n, port, results, done))
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(n):
            try:
                rank, res = results.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(f"{job}: no result in {timeout} s")
            if isinstance(res, str):
                raise RuntimeError(f"rank {rank} of {job} failed:\n{res}")
            out[rank] = res
    finally:
        done.set()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [out[r] for r in range(n)]


def _rows(x: torch.Tensor, rank: int, b: int) -> torch.Tensor:
    return x[rank * b:(rank + 1) * b]


def _opt(params, spec):
    from rspnet_tpu_torch.config import ConfigTree
    from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
    return build_optimizer(ConfigTree.from_dict(spec), params, spec["lr"])


def _moco_model(data, state):
    from rspnet_tpu_torch.models import get_model_class
    from rspnet_tpu_torch.moco import MultiTaskWrapper
    net = MultiTaskWrapper(
        get_model_class(data["arch"], **data["model_cfg"])(),
        num_classes=data["dim"]).double()
    net = net.to(memory_format=torch.channels_last_3d)
    net.load_state_dict(state)
    return net


def moco(data: dict, rank: int) -> dict:
    """Train steps (and one eval step) of the MoCo step under each layout
    of ``data["layouts"]`` ("1d" or "2d"), each from the same state."""
    from rspnet_tpu_torch.models.common import set_bn_process_group
    from rspnet_tpu_torch.moco import (MoCoConfig, MoCoState,
                                       gather_queue_2d, layout_for,
                                       shard_queue_2d)
    from rspnet_tpu_torch.moco import step as tstep
    from rspnet_tpu_torch.parallel import create_mesh, create_mesh_2d

    cfg = MoCoConfig(**data["cfg"])
    b = data["batch"]
    out = {}
    for name in data["layouts"]:
        mesh = (create_mesh_2d(*data["mesh_2d"]) if name == "2d"
                else create_mesh())
        model_q = _moco_model(data, data["state_q"])
        model_k = _moco_model(data, data["state_k"])
        for p in model_k.parameters():
            p.requires_grad_(False)
        for net in (model_q, model_k):
            set_bn_process_group(net, mesh.group)
        queue = data["queue"].clone()
        if mesh.is_2d:
            queue = shard_queue_2d(queue, mesh)
        state = MoCoState(model_q, model_k, queue, 0,
                          _opt(model_q.parameters(), data["opt"]))
        layout = layout_for(mesh)
        res = {"metrics": []}
        for st in data["steps"]:
            c = (cfg if st["speed"] is None
                 else tstep.speed_branch_config(cfg, st["speed"]))
            m = tstep.train_step(
                state, _rows(st["x_q"], rank, b), _rows(st["x_k"], rank, b),
                c, perm=st["perms"][rank], speed_index=0, layout=layout)
            res["metrics"].append({k: float(v) for k, v in m.items()})
        if "eval" in data:
            ev = data["eval"]
            m = tstep.eval_step(
                state, _rows(ev["x_q"], rank, b), _rows(ev["x_k"], rank, b),
                cfg, perm=ev["perms"][rank], speed_index=0, layout=layout)
            res["eval"] = {k: float(v) for k, v in m.items()}
        queue = state.queue
        if mesh.is_2d:
            queue = gather_queue_2d(queue, mesh)
        res.update(q=state.model_q.state_dict(),
                   k=state.model_k.state_dict(), queue=queue,
                   ptr=state.queue_ptr)
        out[name] = res
    return out


def _classifier(data):
    from rspnet_tpu_torch.models import get_model_class
    from rspnet_tpu_torch.moco import MultiTaskWrapper
    net = MultiTaskWrapper(
        get_model_class(data["arch"], **data["model_cfg"])(),
        num_classes=data["num_classes"], finetune=True).double()
    net = net.to(memory_format=torch.channels_last_3d)
    net.load_state_dict(data["state"])
    return net


def classifier(data: dict, rank: int) -> dict:
    """One classifier train step, then the eval step on a padded batch
    (its sums and the gathered logits)."""
    from rspnet_tpu_torch.engines import classifier as cls
    from rspnet_tpu_torch.models.common import set_bn_process_group
    from rspnet_tpu_torch.parallel import create_mesh

    group = create_mesh().group
    net = _classifier(data)
    set_bn_process_group(net, group)
    b = data["batch"]
    m = cls.train_step(net, _opt(net.parameters(), data["opt"]),
                       _rows(data["clips"], rank, b),
                       _rows(data["labels"], rank, b), group=group)
    ev = data["eval"]
    be = ev["batch"]
    sums = cls.eval_step(net, _rows(ev["clips"], rank, be),
                         _rows(ev["labels"], rank, be),
                         _rows(ev["mask"], rank, be), n_crop=ev["n_crop"],
                         group=group, return_logits=True)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": net.state_dict(),
            "sums": {k: v for k, v in sums.items()}}


def precise_bn(data: dict, rank: int) -> dict:
    """Precise-BN over the global batches, each rank on its rows."""
    from rspnet_tpu_torch.engines.precise_bn import recalibrate_bn_stats
    from rspnet_tpu_torch.models.common import set_bn_process_group
    from rspnet_tpu_torch.parallel import create_mesh

    net = _classifier(data)
    set_bn_process_group(net, create_mesh().group)
    b = data["batch"]
    n = recalibrate_bn_stats(net, (_rows(x, rank, b)
                                   for x in data["batches"]))
    return {"n": n, "state": net.state_dict()}


def features(data: dict, rank: int) -> dict:
    """Retrieval's crop features, masks and labels of every rank through
    ``fetch_global``."""
    from rspnet_tpu_torch.engines.retrieval import crop_features
    from rspnet_tpu_torch.parallel import create_mesh, fetch_global

    mesh = create_mesh()
    net = _classifier(data).eval()
    b = data["batch"]
    f = crop_features(net, _rows(data["clips"], rank, b), data["n_crop"])
    return {"feats": fetch_global(f, mesh),
            "mask": fetch_global(_rows(data["mask"], rank, b).numpy(), mesh),
            "labels": fetch_global(_rows(data["labels"], rank, b).numpy(),
                                   mesh)}


def loader(data: dict, rank: int) -> dict:
    """The first batch of this rank's train loader, built for the world's
    global batch."""
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.data.pipeline import build_loader
    from rspnet_tpu_torch.parallel import world_size

    cfg = load_config(data["config"], [data["ext"]])
    ld = build_loader(cfg, "train", vid=True, batch_multiplier=world_size())
    it = iter(ld)
    try:
        batch = next(it)
    finally:
        it.close()
    return {"clips": [torch.from_numpy(c) for c in batch["clips"]],
            "labels": torch.from_numpy(batch["labels"]),
            "index": (ld.cfg.process_index, ld.cfg.process_count)}


def cache_refused(data: dict, rank: int) -> dict:
    """The error of a ``cache_device`` loader built in a group of more
    than one rank."""
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.data.pipeline import build_loader
    from rspnet_tpu_torch.parallel import world_size

    cfg = load_config(data["config"], [data["ext"]])
    try:
        build_loader(cfg, "train", vid=True, batch_multiplier=world_size(),
                     device="cpu")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


JOBS = {"moco": moco, "classifier": classifier, "precise_bn": precise_bn,
        "features": features, "loader": loader,
        "cache_refused": cache_refused}


def several(data: dict, rank: int) -> list:
    """The jobs of ``data["jobs"]`` ((name, data) pairs) in one group."""
    return [JOBS[name](d, rank) for name, d in data["jobs"]]


JOBS["several"] = several
