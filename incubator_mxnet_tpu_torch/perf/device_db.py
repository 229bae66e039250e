"""Device capability database: peak FLOP/s and memory bandwidth per
device kind (twin of ``incubator_mxnet_tpu/perf/device_db.py``).

The port's table holds the cards it runs on, from their makers'
datasheets, and no TPU row.  NVIDIA H100 SXM (``torch.cuda.
get_device_name`` "NVIDIA H100 80GB HBM3"), dense peaks:

- bf16 / fp16 on the tensor cores: 989.4 TFLOP/s
- tf32 on the tensor cores: 494.7 TFLOP/s
- fp32 on the CUDA cores: 66.9 TFLOP/s
- int8 on the tensor cores: 1979 TOP/s
- HBM3: 3.35 TB/s, 80 GB

Each row carries its own fp32 and tf32 peaks: the JAX package's rule
(fp32 = bf16 / 8) is a TPU MXU convention and does not hold on a card.
``peak("float32")`` reads ``torch.backends.cuda.matmul.allow_tf32``: with
TF32 on, fp32 products run on the tensor cores at the tf32 peak, off,
on the CUDA cores at the fp32 peak.

A card with no row gets *nominal* numbers (the CPU's), marked
``nominal``, never another card's.  CPU hosts get nominal numbers too,
overridable via ``MXTPU_PERF_CPU_PEAK_GFLOPS`` / ``MXTPU_PERF_CPU_GBPS``,
so the roofline plumbing produces a verdict anywhere; every report that
uses them carries ``"nominal_peaks": true``.
"""
from ..utils.env import get_env

__all__ = ["DeviceCaps", "DEVICE_DB", "caps_for_kind", "caps_for",
           "peak_flops", "roofline", "hbm_capacity", "headroom"]

# nominal capacity for CPU hosts and unknown cards: the gate needs a
# capacity to plan against; 32 GiB is far above any test-sized graph,
# so the ladder engages only when MXTPU_HBM_BYTES shrinks it on purpose
_CPU_NOMINAL_HBM = 32 * (1 << 30)


class DeviceCaps:
    """Peak capabilities of one device kind."""

    __slots__ = ("kind", "bf16_flops", "hbm_bytes_per_s", "int8_2x",
                 "nominal", "hbm_bytes", "nominal_hbm", "fp32_flops",
                 "tf32_flops", "int8_flops")

    def __init__(self, kind, bf16_flops, hbm_gb_s, int8_2x=False,
                 nominal=False, hbm_gib=None, *, hbm_bytes=None,
                 fp32_flops=None, tf32_flops=None, int8_flops=None):
        self.kind = kind
        self.bf16_flops = float(bf16_flops)
        self.hbm_bytes_per_s = float(hbm_gb_s) * 1e9
        self.int8_2x = bool(int8_2x)
        self.nominal = bool(nominal)
        # capacity: datasheet bytes, or GiB as the JAX rows give it;
        # nominal_hbm marks a placeholder (CPU / unknown kinds)
        self.nominal_hbm = bool(nominal) or (hbm_gib is None
                                             and hbm_bytes is None)
        if hbm_bytes is None:
            hbm_bytes = (hbm_gib if hbm_gib is not None else 32) \
                * (1 << 30)
        self.hbm_bytes = float(hbm_bytes)
        self.fp32_flops = None if fp32_flops is None else float(fp32_flops)
        self.tf32_flops = None if tf32_flops is None else float(tf32_flops)
        self.int8_flops = None if int8_flops is None else float(int8_flops)

    def peak(self, dtype="bfloat16"):
        """Peak FLOP/s for a compute dtype (a string or torch dtype; the
        rules are in the module docstring)."""
        d = str(dtype).replace("torch.", "")
        if d in ("bfloat16", "bf16", "float16", "fp16", "half"):
            return self.bf16_flops
        if d in ("int8", "uint8"):
            if self.int8_flops is not None:
                return self.int8_flops
            return self.bf16_flops * (2.0 if self.int8_2x else 1.0)
        if d in ("tf32", "tensorfloat32"):
            return self.tf32_flops if self.tf32_flops is not None \
                else self.peak("float32")
        if d in ("float32", "fp32", "float"):
            if self.nominal:
                # the CPU's nominal "bf16" number is its fp32 peak
                return self.bf16_flops
            if self.fp32_flops is not None:
                if self.tf32_flops is not None and _tf32_on():
                    return self.tf32_flops
                return self.fp32_flops
            return self.bf16_flops / 8.0
        return self.bf16_flops

    def capacity(self):
        """Usable device memory in bytes: the ``MXTPU_HBM_BYTES``
        override when set (> 0), the datasheet capacity otherwise
        (nominal for CPU / unknown kinds)."""
        override = float(get_env("MXTPU_HBM_BYTES"))
        return override if override > 0 else self.hbm_bytes

    def as_dict(self):
        return {"kind": self.kind, "bf16_flops": self.bf16_flops,
                "fp32_flops": self.peak("float32"),
                "hbm_bytes_per_s": self.hbm_bytes_per_s,
                "nominal": self.nominal,
                "hbm_bytes": self.capacity(),
                "nominal_hbm": self.nominal_hbm}


def _tf32_on():
    import torch
    return bool(torch.backends.cuda.matmul.allow_tf32)


# device-name substring (lower case) -> caps; first match wins.  The
# H100's tag is its SXM name: the PCIe and NVL parts have other peaks
# and no row yet, so they read as unknown (nominal), never as SXM.
DEVICE_DB = [
    DeviceCaps("h100 80gb hbm3", 989.4e12, 3350.0, hbm_bytes=80e9,
               fp32_flops=66.9e12, tf32_flops=494.7e12,
               int8_flops=1979e12),
]


def _cpu_caps(kind="cpu"):
    """Nominal caps (env-overridable; see the module docstring)."""
    return DeviceCaps(
        kind,
        get_env("MXTPU_PERF_CPU_PEAK_GFLOPS") * 1e9,
        get_env("MXTPU_PERF_CPU_GBPS"),
        nominal=True, hbm_gib=_CPU_NOMINAL_HBM >> 30)


def caps_for_kind(kind):
    """Caps for a device-name string; nominal caps (kind kept) when no
    row matches, so a roofline verdict always exists."""
    k = (kind or "").lower()
    for caps in DEVICE_DB:
        if caps.kind in k:
            return caps
    return _cpu_caps(kind or "cpu")


def _device_kind(device):
    """The name of a torch.device / Context / string's device: the
    card's ``get_device_name``, "cpu" for the host."""
    import torch

    from ..context import as_device
    dev = as_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def caps_for(device):
    """Caps for a device (torch.device, Context or string)."""
    return caps_for_kind(_device_kind(device))


def peak_flops(device, dtype="bfloat16"):
    """Peak FLOP/s of a device for a compute dtype, or None for a kind
    with no row ('no peak' means 'report throughput only')."""
    kind = _device_kind(device).lower()
    for caps in DEVICE_DB:
        if caps.kind in kind:
            return caps.peak(dtype)
    return None


def hbm_capacity(device=None):
    """Usable device-memory bytes of a device (default: the current
    context's): the ``MXTPU_HBM_BYTES`` override, else the datasheet
    value, else the nominal capacity."""
    if device is None:
        from ..context import current_context
        device = current_context()
    return caps_for(device).capacity()


def headroom(used_bytes, device=None, margin=None):
    """Bytes of device memory still available after ``used_bytes``,
    holding back ``margin`` (default ``MXTPU_MEM_GATE_MARGIN``) of the
    capacity for fragmentation and unmodeled scratch.  Negative = over
    budget."""
    if margin is None:
        margin = float(get_env("MXTPU_MEM_GATE_MARGIN"))
    cap = hbm_capacity(device)
    return cap * (1.0 - margin) - float(used_bytes)


def roofline(flops, bytes_moved, caps, dtype="bfloat16"):
    """Classify one workload against a device's roofline: predicted
    time = max(compute time, memory time); within 10% of the ridge both
    walls matter ("balanced")."""
    peak = caps.peak(dtype)
    bw = caps.hbm_bytes_per_s
    t_compute = flops / peak if peak else 0.0
    t_memory = bytes_moved / bw if bw else 0.0
    t = max(t_compute, t_memory)
    if t <= 0.0:
        bound = "idle"
    elif abs(t_compute - t_memory) <= 0.1 * t:
        bound = "balanced"
    elif t_compute > t_memory:
        bound = "compute"
    else:
        bound = "memory"
    intensity = (flops / bytes_moved) if bytes_moved else 0.0
    ridge = (peak / bw) if bw else 0.0
    return {"predicted_s": t, "compute_s": t_compute,
            "memory_s": t_memory, "bound": bound,
            "arithmetic_intensity": intensity,
            "ridge_intensity": ridge,
            "peak_flops": peak, "hbm_bytes_per_s": bw,
            "nominal_peaks": caps.nominal}
