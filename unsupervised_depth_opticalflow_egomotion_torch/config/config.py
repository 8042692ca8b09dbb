"""Typed configuration: YAML preset + CLI overrides -> one dataclass.

The PyTorch port's own copy of the JAX package's ``config/config.py`` (the
port imports nothing of the JAX package): same fields, same defaults, same
YAML presets. Field comments that cite TPU measurements describe the JAX
package. What the kernel-selecting fields run in this port, on a CUDA tensor
(on a CPU tensor every kernel wrapper runs its plain PyTorch version):

- ``ssim_impl``: "pallas" (default) = the SSIM forward and closed-form
  backward kernels (csrc/ssim.cu) at every scale; "xla" = the plain map under
  autograd.
- ``warp_impl``, for 3-channel data sources: "pallas_fused" (default) = the
  warp gather that also writes its derivative planes, elementwise backward;
  "pallas" = the gather without planes and the re-gather backward kernel
  (csrc/warp_gather.cu); "xla" = the plain sampler. ``warp_bf16=False``
  sends float data sources to the plain sampler and keeps the kernel for
  uint8 ones. ``warp_guard`` is accepted and has nothing to guard: the
  gathers and the splat scatter are exact at any displacement.
- ``pwc_corr``: "fused" (default) = the cost-volume forward and both
  backward kernels (csrc/correlation.cu); "pallas" = the forward kernel with
  the plain backward; "xla" = the plain cost volume.
- ``flow_occ_impl`` (flow mode): "splat" = the forward-splat kernel
  (csrc/splat.cu); "splat_xla", "splat_nn" (default), "splat_nn_half" and
  "diff_weights" are plain PyTorch on every device, as the JAX package keeps
  them outside its kernels.

Loss-weight mapping mirrors the reference's config_utils.py:3-22.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional

import yaml


@dataclass
class Config:
    # identification / mode
    cfg_name: str = "default"
    mode: str = "geom"  # flow | depth | geom
    dataset: str = "kitti_depth"  # kitti_depth | kitti_odo | nyu

    # dataset paths
    raw_base_dir: str = ""
    kitti_odom_dir: str = ""
    prepared_base_dir: str = ""
    gt_2012_dir: str = ""
    gt_2015_dir: str = ""
    static_frames_txt: str = ""
    test_scenes_txt: str = ""
    eigen_test_files_txt: str = ""
    eigen_gt_depths_npz: str = ""
    nyu_test_dir: str = ""  # dir holding nyu_depth_v2_labeled.mat + splits.mat
    nyu_stride: int = 10  # frame stride for NYU 3-frame stacks
    sequences: tuple = ("09",)

    # model geometry
    num_scales: int = 3
    num_input_frames: int = 3
    img_hw: tuple = (256, 832)

    # training
    num_iterations: int = 200_000
    batch_size: int = 8
    lr: float = 1e-4
    num_workers: int = 8
    # host input pipeline: "native" = the C++ decode/resize service
    # (native/kitti_data_service.cc) over a ctypes ring buffer, "python" =
    # the threaded cv2 BatchLoader, "auto" = native when buildable
    loader_impl: str = "auto"
    log_interval: int = 100
    test_interval: int = 2000
    save_interval: int = 2000
    model_dir: str = "./checkpoints"
    resume: bool = False
    iter_start: int = 0
    flow_pretrained_model: str = ""
    depth_pretrained_model: str = ""
    fix_flow: bool = False
    fix_depth: bool = False
    fix_pose: bool = False
    seed: int = 0

    # precision / parallelism
    compute_dtype: str = "bfloat16"
    remat: bool = False  # rematerialize conv stacks in backward (enable for
    # larger batch/resolution than the default b8 256x832, which fits without)
    packed_convs: bool = True  # space-to-depth packed small-channel convs
    # (numerically equivalent; 1.7-2.5x faster on TPU -- ops/packed_conv.py)
    packed_encoder: bool = False  # (1,2) width-packed ResNet layer-1 segment
    # with exact packed BatchNorm (models/depth_net.py); checkpoint tree is
    # unchanged. Off until the hardware win lands in PERF.md.
    packed_stem: bool = False  # (4,4)->(2,2) packed form of the 7x7 s2 stem
    # conv (contract 48 ch/tap into 256 lanes instead of 3 ch/tap into 64;
    # ops/packed_conv.py:pack_kernel_stem). Off until measured.
    depth_smooth_norm: bool = False  # mean-normalized disparity smoothness
    # (monodepth2-style d/mean(d) before differencing): scale-invariant
    # smoothness pressure, the lever for the measured scale-drift <-> AbsRel
    # co-movement (TRAINING.md r5 scale-drift analysis). Off = reference
    # semantics (model_geometry.py:225-252 has no normalization).
    encoder_int8: bool = False  # int8 forwards for the depth encoder convs
    # (ops/int8_conv.py: dynamic-range quant, int32 accumulate, STE
    # backward). The v5e MXU's int8 mode is 2x bf16 peak; the conv pool is
    # the step's largest block (PERF.md r5 decomposition). Off by default
    # pending the hardware A/B + quality run.
    pwc_corr: str = "fused"  # "xla" | "pallas" | "fused": PWC correlation impl
    # (hardware measurements in PERF.md; "fused" = round-3 channel-major
    # Pallas fwd+bwd kernels, ops/pallas/correlation_fused.py)
    warp_impl: str = "pallas_fused"  # "xla" | "pallas" | "pallas_fused": warp
    # sampler for uint8 RGB sources. "pallas"/"pallas_fused" = the windowed
    # dynamic-gather kernel (ops/pallas/warp_window.py): per-band VMEM source
    # windows + intra-vreg lane shuffles instead of the platform-rate global
    # row gather (geom step 43.5 -> 51.3 fps/chip, PERF.md round-4; value/grad
    # parity vs the XLA sampler in tests/test_warp_window.py, displacement
    # clamped beyond +-128 px horizontal / 53 px per-band vertical variation);
    # "pallas_fused" additionally emits the analytic coordinate derivatives in
    # the forward so the backward is elementwise (no re-gather). Combined with
    # warp_bf16 below: 51.3 -> 55.8 fps/chip (PERF.md round-4 variants table).
    # Float ACTIVATION sources and off-TPU backends keep the XLA path.
    warp_bf16: bool = True  # extend the Pallas warp kernel to bf16
    # 3-channel DATA sources (the scale>=1 photometric image pyramids;
    # bf16 bit pairs packed into i32 words, 2 gathers/tap). Hardware win
    # measured in PERF.md round-4; parity in tests/test_warp_window.
    warp_guard: bool = True  # displacement guard for the windowed kernels
    # (warp + splat): lax.cond on a cheap coverage-violation count falls
    # back to the exact XLA sampler/scatter for any step whose motion
    # exceeds the kernel windows (+-128 px horizontal taps, >win-2 row
    # vertical band spread) -- extreme flows cost speed, never bias.
    # Guard predicates: ops/pallas/warp_window.py:warp_coverage_violations,
    # ops/pallas/splat_window.py:splat_coverage_violations.
    ssim_impl: str = "pallas"  # "xla" | "pallas": SSIM map impl. "pallas" =
    # the fused single-pass fwd+bwd kernel (ops/pallas/ssim_fused.py) on
    # planes where it measures faster (>=128x416; hardware table in PERF.md),
    # XLA elsewhere; value and gradient pinned against the XLA form in
    # tests/test_pallas_kernels.py.
    flow_occ_impl: str = "splat_nn"  # flow-mode occlusion:
    # "splat_nn" (default: single-tap nearest forward splat; 1/4 the scatter
    # rows of "splat" -> flow train step 31.5 -> 67.3 fps/chip, equal
    # learning in the synthetic A/B: EPE 10.16 vs 10.03 at 3k steps,
    # TRAINING.md) | "splat" (4-tap bilinear forward splat; soft boundary
    # mask values; on TPU this takes the round-5 windowed Pallas splat
    # kernel, ops/pallas/splat_window.py -- scatter reformulated as MXU
    # tent-matrix matmuls) | "splat_xla" (forces the XLA scatter-add form
    # of "splat"; the kernel A/B escape) | "splat_nn_half" (nearest splat
    # on a half-res grid for large planes; 1/16 the scatter rows of
    # "splat") | "diff_weights" (faithful model_flow.py soft weights;
    # parity-anchored, known-degenerate -- see joint.py)
    flow_occ_switch_step: int = 0  # flow-mode occlusion schedule: train with
    # ``flow_occ_impl`` (fast splat_nn) up to this step, then switch to the
    # 4-tap bilinear "splat" for the final-convergence tail (one recompile at
    # the boundary). Captures splat_nn's ~2.2x throughput without its noisy
    # late-training mask flicker (TRAINING.md flow_nn12k). 0 = no switch.
    loss_base_scale: int = 0  # half-resolution loss dial: base the whole loss
    # pyramid this many octaves below the input resolution. Networks and
    # inference are unchanged (full-res disp/flow heads remain); training
    # losses, masks and warp gathers evaluate on the downscaled grid. 0 =
    # reference behaviour; 1 measured as a quality/speed dial (PERF.md,
    # TRAINING.md). Requires loss_base_scale + num_scales <= 4.
    decode_cache_bytes: int = 2 << 30  # host decoded-PNG cache budget (0 = off)
    grad_clip_norm: float = 0.0  # optax global-norm gradient clip (0 = off;
    # the reference has none -- an opt-in stabilizer for from-scratch stages)
    data_axis: str = "data"
    num_devices: int = 0  # 0 = all visible
    # multi-host (SURVEY 2.7 DCN axis): set num_processes > 1 and launch one
    # process per host with its process_id; on TPU pods the coordinator is
    # autodetected (leave coordinator_address empty). Each host feeds its
    # train.txt shard; batch_size stays GLOBAL and must divide by the
    # process count.
    coordinator_address: str = ""
    num_processes: int = 0  # 0/1 = single-process
    process_id: int = -1

    # loss weights (config_utils.py:3-22, kitti_geom.yaml:20-34)
    w_flow_pixel: float = 0.15
    w_flow_ssim: float = 0.85
    w_flow_smooth: float = 10.0
    w_flow_consis: float = 0.01
    w_depth_pixel: float = 1.0
    w_depth_ssim: float = 0.85
    w_depth_smooth: float = 0.5
    w_depth_consis: float = 0.1
    w_depth_flow_consis: float = 1.0
    w_epipolar: float = 0.1
    w_triangle: float = 0.001
    w_pnp: float = 0.1
    w_8point: float = 0.1

    # geometric hyperparameters (kitti_geom.yaml:36-47)
    flow_consist_alpha: float = 0.01
    flow_consist_beta: float = 0.5
    dyna_photo_weight: float = 2.0  # dynamic-region photometric weight
    # (reference hard-codes 2x; the moving-region A/B dial, TRAINING.md)
    ransac_iters: int = 100
    ransac_points: int = 6000
    geometric_ratio: float = 0.3
    geometric_num: int = 6000
    pose_beta: float = 1.0

    # optional-loss toggles (reference ships these disabled,
    # model_geometry.py:891-951)
    enable_depth_ssim: bool = False
    enable_depth_consis: bool = False
    enable_triangle: bool = False
    enable_pnp: bool = False
    enable_eight_point: bool = False

    def __post_init__(self):
        h, w = self.img_hw
        if h % 64 or w % 64 or h < 64 or w < 64:
            raise ValueError(
                f"img_hw must be multiples of 64 and >= 64 (PWC's 6-level "
                f"coarse-to-fine pyramid and the ResNet18 skip decoder both "
                f"require it); got {tuple(self.img_hw)}"
            )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=list)


def load_config(yaml_path: Optional[str] = None, **overrides: Any) -> Config:
    """Build a Config from an optional YAML preset plus keyword overrides.

    Unknown YAML keys are ignored (forward compatibility with
    reference-style YAML files).
    """
    data: dict[str, Any] = {}
    if yaml_path:
        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(Config)}
        for k, v in raw.items():
            if k in fields:
                data[k] = v
    data.update({k: v for k, v in overrides.items() if v is not None})
    for key in ("img_hw", "sequences"):
        if key in data and isinstance(data[key], list):
            data[key] = tuple(data[key])
    return Config(**data)


# loss_pack key -> config weight attribute (config_utils.py:3-22)
_WEIGHT_MAP = {
    "loss_flow_pixel": "w_flow_pixel",
    "loss_flow_ssim": "w_flow_ssim",
    "loss_flow_smooth": "w_flow_smooth",
    "loss_flow_consis": "w_flow_consis",
    "loss_depth_pixel": "w_depth_pixel",
    "loss_depth_ssim": "w_depth_ssim",
    "loss_depth_smooth": "w_depth_smooth",
    "loss_depth_consis": "w_depth_consis",
    "loss_depth_flow_consis": "w_depth_flow_consis",
    "loss_epipolar": "w_epipolar",
    "loss_triangle": "w_triangle",
    "loss_pnp": "w_pnp",
    "loss_eight_point": "w_8point",
}


def loss_weights(cfg: Config) -> dict[str, float]:
    """loss_pack key -> scalar weight."""
    return {k: float(getattr(cfg, attr)) for k, attr in _WEIGHT_MAP.items()}
