"""Pieces the loops share: the program's network built from the
benchmark's weights, the reference built from the same, the seeds."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from posebench import inputs, weights
from posebench.reference import model as ref

# one tag per use of a run's seed
SEED_WEIGHTS, SEED_CROPS, SEED_KEYPOINTS, SEED_POSES, SEED_SAMPLE, SEED_SOLVER = range(1, 7)
SEED_ARRIVALS, SEED_STEPS, SEED_CALIBRATION, SEED_OBJECTS = 7, 8, 9, 10
CALIBRATION_CROPS = 16

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_kwargs(model: Dict, dtype) -> Dict:
    """The program's PoseNet arguments for a configuration's `model` group."""
    return dict(npoint=model["npoint"], res_log2=model["res_log2"],
                backbone_name=model["backbone"], num_filters=model["num_filters"],
                query_dims=tuple(model["query_dims"]), seg_output_dim=model["seg_output_dim"],
                local_k=model["local_k"], leaky_slope=model["leaky_slope"],
                num_graph_module=model["num_graph_module"],
                graph_leaky_slope=model["graph_leaky_slope"],
                init_num_graph_module=model["init_num_graph_module"],
                init_graph_leaky_slope=model["graph_leaky_slope"], dtype=dtype)


def program_net(config: Dict, state: Dict[str, torch.Tensor], device):
    """The program's PoseNet, built without an initialisation of its own and
    loaded with the benchmark's weights, in eval mode."""
    from checkerpose_tpu_torch.models.posenet import PoseNet
    with torch.device("meta"):
        net = PoseNet(**port_kwargs(config["model"], DTYPES[config["dtype"]]))
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net.eval()


def reference_net(config: Dict, state: Dict[str, torch.Tensor], device):
    ref.set_reference_flags()
    net = ref.build(config["model"]).to(device)
    net.load_state_dict(state)
    return net.eval()


def state_for(ctx) -> Dict[str, torch.Tensor]:
    """The run's weights, its RoI and seg heads centred (weights.center_heads)."""
    model, dev = ctx.cell.config["model"], ctx.device
    state = weights.make_state_dict(model, inputs.torch_seed(ctx.seed, SEED_WEIGHTS), dev)
    crops = inputs.device_crops(inputs.torch_seed(ctx.seed, SEED_CALIBRATION),
                                CALIBRATION_CROPS, dev)
    knn = torch.as_tensor(keypoint_sets(ctx)[2][0], device=dev)
    weights.center_heads(state, model, inputs.normalize_image(crops), knn)
    return state


def keypoint_sets(ctx):
    cfg = ctx.cell.config
    return inputs.keypoints(inputs.rng_for(ctx.seed, SEED_KEYPOINTS), cfg["objects"],
                            cfg["model"]["npoint"], cfg["knn_k"])


def edgeconvs(net):
    from checkerpose_tpu_torch.models.graph import EdgeConv
    return [m for m in net.modules() if isinstance(m, EdgeConv)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def launches(ctx) -> Dict[str, int]:
    """The program's EdgeConv counters (kernel launches by route, per-sample calls)."""
    from checkerpose_tpu_torch.ops.edgeconv import edgeconv_eval_per_sample, edgeconv_fused
    return {"tc": edgeconv_fused.launches_by_route["tc"],
            "fma": edgeconv_fused.launches_by_route["fma"],
            "per_sample": edgeconv_eval_per_sample.calls}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
