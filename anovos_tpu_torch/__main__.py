"""``python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json] [--resume]``:
run a YAML config through the port's runner on the GPU.  ``--resume``
re-runs a killed config in the same directory: it sets ``ANOVOS_TPU_CACHE``
to ``.anovos_cache`` when it is unset, so the nodes the killed run
committed restore from the node cache, and the streaming passes resume
from their chunk checkpoints."""

import json
import logging
import os
import sys

USAGE = "usage: python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json] [--resume]"


def parse_args(argv):
    """(config_path, run_type, auth_key_val, resume) from the command line,
    ``--resume`` anywhere after the program; exits with the usage line
    when there is no config."""
    resume = "--resume" in argv[1:]
    argv = [argv[0]] + [a for a in argv[1:] if a != "--resume"]
    if len(argv) < 2:
        sys.exit(USAGE)
    run_type = argv[2] if len(argv) > 2 else "local"
    auth_key_val = {}
    if len(argv) > 3:
        # a JSON dict; anything else (bare token, JSON scalar) is wrapped
        try:
            auth_key_val = json.loads(argv[3])
        except json.JSONDecodeError:
            auth_key_val = {"auth_key": argv[3]}
        if not isinstance(auth_key_val, dict):
            auth_key_val = {"auth_key": argv[3]}
    return argv[1], run_type, auth_key_val, resume


if __name__ == "__main__":
    config_path, run_type, auth_key_val, resume = parse_args(sys.argv)
    if resume:
        # a resume needs a cache root, set before the runner is imported
        os.environ.setdefault("ANOVOS_TPU_CACHE", ".anovos_cache")
    # entrypoint-only root-logger setup: library modules never call
    # logging.basicConfig
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from anovos_tpu_torch import workflow

    workflow.run(config_path, run_type, auth_key_val, resume=resume)
