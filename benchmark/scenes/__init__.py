"""Scene generators, one module per generator named in a configuration's
``scene.generator``, and the file cache: each (configuration, seed) is
written once as a g2o file under the checkout's cache directory."""

from __future__ import annotations

import hashlib
import importlib
import json
import os


def generate(config: dict, seed: int):
    """The configuration's scene for seed (the generator module's
    ``generate(params, seed)``)."""
    spec = config["scene"]
    mod = importlib.import_module(f"benchmark.scenes.{spec['generator']}")
    return mod.generate(spec["params"], seed)


def scene_file(config: dict, scene, seed: int, cache_dir: str) -> str:
    """Path of the scene's g2o file, written on first use of (config, seed)."""
    # the file's name holds the scene's definition, so a changed definition
    # never reads an older file
    key = hashlib.sha256(json.dumps(config["scene"], sort_keys=True).encode()).hexdigest()
    directory = os.path.join(cache_dir, "scenes", config["name"])
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{key[:16]}_seed_{seed}.g2o")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        scene.write(tmp)
        os.replace(tmp, path)
    return path
