"""``python -m marl_distributedformation_tpu_torch.train key=value ...``
(see ``cli.py``)."""

from marl_distributedformation_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
