"""``python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json]``:
run a YAML config through the port's runner on the GPU."""

import json
import logging
import sys

USAGE = "usage: python -m anovos_tpu_torch <config.yaml> [run_type] [auth_key_json]"


def parse_args(argv):
    """(config_path, run_type, auth_key_val) from the command line; exits
    with the usage line when there is no config."""
    if "--resume" in argv:
        sys.exit("--resume is not supported by anovos_tpu_torch: the port has no cache store "
                 "yet (ROADMAP.md Queue A item 4)\n" + USAGE)
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
    return argv[1], run_type, auth_key_val


if __name__ == "__main__":
    config_path, run_type, auth_key_val = parse_args(sys.argv)
    # entrypoint-only root-logger setup: library modules never call
    # logging.basicConfig
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from anovos_tpu_torch import workflow

    workflow.run(config_path, run_type, auth_key_val)
