"""Port of ``elaina_tpu/core/config.py`` (stdlib only).

Experiment configuration: the reference JSON schema, unchanged.

Path-style lookups (``a/b/c``) mirror json_get_or_throw / json_get_optional
(core/common.h:127-213); the settings are the union of
UniformIntegratorSettings (uniform/integrator.h:28-49) and the guided
integrator's (guided/integrator.h:62-66), which the uniform one ignores.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any


def json_get(conf: dict, path: str, default=..., required: bool = False):
    node: Any = conf
    for part in path.split("/"):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            if required:
                raise KeyError(f"missing required config key: {path!r}")
            return None if default is ... else default
    return node


def json_get_or_throw(conf: dict, path: str):
    return json_get(conf, path, required=True)


def json_get_optional(conf: dict, path: str, default=None):
    return json_get(conf, path, default=default)


def load_json_file(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


@dataclass
class IntegratorSettings:
    frameSize: tuple = (800, 800)
    samplesPerPixel: int = 512
    maxWalkingDepth: int = 32
    saveSppMetricsDuration: int = -1
    saveSppMetricsUntil: int = 1024
    saveTimeMetricsDuration: int = -1
    epsilonShell: float = 1e-5

    # guided only (guided/integrator.h:62-66)
    trainSppCount: int = 150
    uniformFractionInTrainingPhase: float = 0.5
    uniformFractionInGuidingPhase: float = 0.5
    maxGuidedDepthInTrainingPhase: int = 10
    maxGuidedDepthInGuidingPhase: int = 10

    @classmethod
    def from_json(cls, conf: dict) -> "IntegratorSettings":
        s = cls()
        for key in list(vars(s)):
            if key in conf:
                val = conf[key]
                if key == "frameSize":
                    val = (int(val[0]), int(val[1]))
                setattr(s, key, val)
        return s


@dataclass
class ExportSpec:
    type: str          # "image" | "energy"
    channel: str       # ExportImageChannel name
    file_name: str
    tone: str | None = None


@dataclass
class ExperimentConfig:
    dimensionality: int
    base_path: str
    exp_name: str
    integrator_type: str               # "uniform" | "guided"
    settings: IntegratorSettings
    channels: list
    exports: list
    scene: dict
    network: dict | None = None        # the guide's encoding, MLP, optimizer
    print_network: bool = False

    @classmethod
    def from_file(cls, path: str) -> "ExperimentConfig":
        conf = load_json_file(path)
        return cls.from_json(conf)

    @classmethod
    def from_json(cls, conf: dict) -> "ExperimentConfig":
        integ = json_get_or_throw(conf, "integrator")
        exports = [
            ExportSpec(
                type=json_get_or_throw(e, "type"),
                channel=json_get_or_throw(e, "channel"),
                file_name=json_get_or_throw(e, "file_name"),
                tone=json_get_optional(e, "tone"),
            )
            for e in json_get_optional(conf, "export", [])
        ]
        return cls(
            dimensionality=int(json_get_or_throw(conf, "dimensionality")),
            base_path=str(json_get_or_throw(conf, "base_path")),
            exp_name=str(json_get_or_throw(conf, "exp_name")),
            integrator_type=str(json_get_or_throw(integ, "type")),
            settings=IntegratorSettings.from_json(json_get_or_throw(integ, "setting")),
            channels=list(json_get_optional(integ, "channels", [])),
            exports=exports,
            scene=json_get_or_throw(conf, "scene"),
            network=json_get_optional(conf, "network"),
            print_network=bool(json_get_optional(conf, "print_network",
                                                 False)),
        )
