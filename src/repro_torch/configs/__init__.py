"""Architecture registry — `--arch <id>` selects one of the 10 assigned
configs (DESIGN.md §6). Each module exposes CONFIG: ArchConfig."""

from repro_torch.configs.base import ArchConfig, RunConfig, ShapeCell, SHAPES, LayerSpec

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internlm2-20b": "internlm2_20b",
    "starcoder2-15b": "starcoder2_15b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "whisper-medium": "whisper_medium",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-26b": "internvl2_26b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    import importlib
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG


def cells_for(arch_id: str) -> list[str]:
    """Shape cells this arch runs (DESIGN.md §6 skips)."""
    cfg = get_config(arch_id)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        cells.append("long_500k")
    return cells
