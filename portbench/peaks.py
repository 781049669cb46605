"""The published peaks of the cards the benchmark runs on, by the name
that ``torch.cuda.get_device_name()`` gives (NVIDIA's data sheets, at
the card's full power limit): only those a metric reads."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def of(kind: str) -> dict | None:
    return PEAKS.get(kind)
