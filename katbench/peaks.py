"""Published peaks of the cards a cell may run on, by the name that
`torch.cuda.get_device_name()` gives.  NVIDIA's data sheet for the H100
SXM part: 3.35 TB/s of HBM3 (a frozen copy of kat_tpu_torch/benchmarks/
workloads.py's HBM_BYTES_PER_S), at the full power limit of 700 W."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    """The card's published memory bandwidth, or None for a card the table
    does not hold (a roofline share is then not reported)."""
    return HBM_BYTES_PER_S.get(device_name)
