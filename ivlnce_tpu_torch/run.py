"""Entry point of the PyTorch port (mirrors the repository's run.py):

    python -m ivlnce_tpu_torch.run --run-type {train,eval} \
        --exp-config <yaml> [--device cuda|cpu] [opt.key value ...]

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without ``--device cpu`` it raises. ``train`` runs DAgger collection
and training (the ``dagger`` and ``iterative_collection_dagger``
trainers), ``eval`` the episodic and iterative evaluations; ``inference``
is not ported yet."""

from __future__ import annotations

import argparse
import random

import numpy as np


def register_all() -> None:
    """Import the modules whose decorators fill the port's registry."""
    import ivlnce_tpu_torch.envs.env  # noqa: F401  (envs, datasets, sensors)
    import ivlnce_tpu_torch.mapping.obs_transforms  # noqa: F401
    import ivlnce_tpu_torch.models.policy  # noqa: F401
    import ivlnce_tpu_torch.tasks.measures  # noqa: F401
    # the three trainers (each module imports the one it extends)
    import ivlnce_tpu_torch.trainers.iterative_dagger_trainer  # noqa: F401


def run_exp(exp_config: str, run_type: str, opts=None, device=None):
    """Build the configured trainer and run it; returns the trainer."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.utils import logging_util
    from ivlnce_tpu_torch.utils.registry import registry

    register_all()
    config = get_config(exp_config, opts)
    logging_util.logger.info(f"config: {config.dump()}")
    logging_util.add_filehandler(config.LOG_FILE)
    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)
    if run_type not in ("train", "eval"):
        raise NotImplementedError(
            f"--run-type {run_type} waits for a later slice of the port"
        )
    trainer = registry.get_trainer(config.TRAINER_NAME)(config, device)
    if run_type == "train":
        trainer.train()
    else:
        trainer.eval()
    return trainer


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-type", choices=["train", "eval"],
                        required=True)
    parser.add_argument("--exp-config", type=str, required=True)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options from command line")
    args = parser.parse_args()
    run_exp(args.exp_config, args.run_type, args.opts, args.device)


if __name__ == "__main__":
    main()
