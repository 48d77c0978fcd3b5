"""A cell at a width a CPU test run holds, built like ``harness.Cell``."""

from __future__ import annotations

import argparse
import copy
import types

from portbench import harness

GENES, GENOMES, HIDDEN, LATENT = 300, 200, 16, 4


def cell(name: str, **traffic) -> types.SimpleNamespace:
    """The cell ``name`` of BENCHMARK.json with its configuration cut to a
    tiny width and its traffic updated by ``traffic``."""
    real = harness.Cell(name)
    config = copy.deepcopy(real.config)
    config.update(input_dim=GENES, genomes=GENOMES)
    config["experiment"].update(hidden_dim=HIDDEN, latent_dim=LATENT)
    return types.SimpleNamespace(
        name=name, chips=1, config=config, traffic=dict(real.traffic, **traffic),
        limits=dict(real.limits), driver=real.driver,
        end_to_end=real.end_to_end, per_layer=real.per_layer)


def args(seed: int, seconds: float = 0.5, trace: int = 0) -> argparse.Namespace:
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
