"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np


def default_mesh(
    n_devices: Optional[int] = None,
    data_axis: str = "data",
    devices: Optional[Sequence[jax.Device]] = None,
) -> jax.sharding.Mesh:
    """A 1-D mesh over ``n_devices`` (default: all local devices), with the
    corpus sharded along ``data_axis``."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.sharding.Mesh(np.asarray(devs), (data_axis,))


def mesh_2d(
    data: int,
    model: int,
    data_axis: str = "data",
    model_axis: str = "model",
    devices: Optional[Sequence[jax.Device]] = None,
) -> jax.sharding.Mesh:
    """A ``data x model`` mesh: corpus rows sharded over ``data_axis`` and
    the embedding dim sharded over ``model_axis`` (partial dot products
    reduced with a psum)."""
    devs = list(devices) if devices is not None else jax.devices()
    assert data * model <= len(devs), (
        f"need {data * model} devices, have {len(devs)}"
    )
    grid = np.asarray(devs[: data * model]).reshape(data, model)
    return jax.sharding.Mesh(grid, (data_axis, model_axis))
