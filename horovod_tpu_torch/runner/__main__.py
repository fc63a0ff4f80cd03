"""``python -m horovod_tpu_torch.runner``: the launcher, as
``python -m horovod_tpu_torch.runner.launch``."""

from horovod_tpu_torch.runner.launch import main

if __name__ == "__main__":
    main()
