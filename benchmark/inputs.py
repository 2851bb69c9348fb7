"""The benchmark's inputs, made from a configuration file, a traffic file
and nothing else: the scene files (written once into the checkout's
cache), the noise table both sides read, the camera and the lights.

Scene generators and light layouts are found by the name the data file
gives: scenes/<generator>.py (write(scene, vks_path, texture_dir)) and
layouts/<layout>.py (lights(**parameters)), so that a new scene or layout
is a new file. They and the noise writer are frozen copies of the port's
generators at commit b4b0e8b (frozen/tools/), so that a later change to
the program cannot move what the benchmark feeds it. Lights and the
camera are plain numbers here; the harness hands them to the port as its
own classes.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Everything a run writes: scene files, the noise table and the kernel
# caches a library may keep. A fixed path inside the checkout, so that only
# the first run of a cell in a checkout writes it.
CACHE_DIR = os.path.join(HERE, "cache")
DATA_DIR = os.path.join(CACHE_DIR, "data")
NOISE_SIZE = (256, 256, 64)  # the reference's Sobol-family table size


def read_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json("..", "BENCHMARK.json")


def cell_files(workload: str) -> tuple[dict, dict, dict]:
    """(the workload's BENCHMARK.json entry, its configuration file, its
    traffic file), each found by name."""
    entries = {w["name"]: w for w in manifest()["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(entries)})")
    entry = entries[workload]
    config = read_json("configs", f"{entry['config']}.json")
    traffic = read_json("traffic", f"{entry['traffic']}.json")
    return entry, config, traffic


# -- scenes ---------------------------------------------------------------

def scene_stem(scene: dict) -> str:
    """A file name that changes with every parameter of the scene."""
    def text(value):
        return "x".join(map(str, value)) if isinstance(value, list) \
            else str(value)
    params = "_".join(f"{k}{text(scene[k])}" for k in sorted(scene)
                      if k != "generator")
    return f"{scene['generator']}_{params}"


def load_module(folder: str, name: str):
    """<folder>/<name>.py as a module: scene generators, light layouts and
    metric readers are found by their name in a data file."""
    import importlib.util
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_scene(scene: dict, data_dir: str | None = None
                ) -> tuple[str, str]:
    """Write (once) the scene the configuration names, with the generator
    scenes/<generator>.py; (.vks path, texture directory). A finished
    scene has a `.done` marker, written last, so a run cut while writing
    leaves nothing that a later run would trust."""
    data_dir = data_dir or DATA_DIR
    stem = scene_stem(scene)
    vks = os.path.join(data_dir, f"{stem}.vks")
    textures = os.path.join(data_dir, f"{stem}_textures")
    if os.path.exists(vks + ".done"):
        return vks, textures
    os.makedirs(data_dir, exist_ok=True)
    load_module("scenes", scene["generator"]).write(scene, vks, textures)
    with open(vks + ".done", "w") as f:
        f.write(json.dumps(scene) + "\n")
    return vks, textures


def write_noise(noise_type: str, data_dir: str | None = None) -> str:
    """Write (once) the noise table that both the port and the reference
    read, under the name the port's loader looks for first."""
    from frozen.tools.generate_noise import ahmed_blob, sobol_family_blob
    w, h, layers = NOISE_SIZE
    path = os.path.join(data_dir or DATA_DIR, "noise",
                        f"{noise_type}_rgba_{w:02d}x{h:02d}_{layers:02d}.blob")
    if os.path.exists(path):
        return path
    table = ahmed_blob(w, h, layers) if noise_type == "ahmed_2d" \
        else sobol_family_blob(noise_type, w, h, layers)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    partial = path + ".partial"
    table.tofile(partial)
    os.replace(partial, path)
    return path


# -- lights and cameras ----------------------------------------------------

def lights(traffic: dict) -> list[dict]:
    """The traffic's lights: layouts/<layout>.py's lights(**parameters)."""
    params = dict(traffic["lights"])
    return load_module("layouts", params.pop("layout")).lights(**params)


def camera(config: dict) -> dict:
    """Position and rotations of the configuration's camera; rotations
    are given in units of pi, as the port's setups write them."""
    cam = config["camera"]
    return dict(position_world_space=np.array(cam["position"], np.float32),
                rotation_x=cam["rotation_x_over_pi"] * np.pi,
                rotation_z=cam["rotation_z_over_pi"] * np.pi)


def settings_fields(config: dict, traffic: dict) -> dict:
    """RenderSettings fields by name, enums by member name: the
    configuration's, then the traffic's."""
    return {**config["settings"], **traffic["settings"]}
