"""``python -m cup2d_tpu_torch.analysis`` entry point."""

from .cli import main

main()
