"""`python -m reart_tpu_torch robot [flags]`."""

from reart_tpu_torch.cli import main

if __name__ == "__main__":
    main()
