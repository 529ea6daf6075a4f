"""Data parallelism over walks across ranks of ``torch.distributed``
(``dp.py``) and its dry run (``dryrun.py``)."""
