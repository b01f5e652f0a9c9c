"""JSON save/load helpers (a copy of sd_lora_trainer_tpu/utils/json_stuff.py)."""

import json


def save_as_json(data, filename: str) -> None:
    with open(filename, "w") as f:
        json.dump(data, f, indent=2, default=str)


def load_json(filename: str):
    with open(filename, "r") as f:
        return json.load(f)
