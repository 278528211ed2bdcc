"""Measurement tools of the port, the counterparts of the repo's ``tools/``:
``prof_kernel`` (the env-last fat-row sweep per row visit) and
``prof_step`` (phases of the batched spider step). Run each with
``python -m evomotion_tpu_torch.tools.<name>``; they run on the card unless
given ``--device cpu``."""
