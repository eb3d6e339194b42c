"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates without sparsity, at the card's full power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,  # float32 outside the tensor cores (TF32 off)
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12,
    },
}


def peak(kind: str, name: str) -> float:
    """The card's peak ``name``; an unknown card raises (no guessed peak)."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; add them to benchmark/peaks.py")
    return PEAKS[kind][name]
