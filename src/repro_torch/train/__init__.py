"""LM training on one process or a device mesh, the port's counterpart of
``repro.train``: ``optimizer`` (AdamW, Adafactor, clipping, schedules, over
the reference's leaf view), ``compression`` (int8 with error feedback),
``checkpoint`` (the reference's on-disk layout), ``fault_tolerance``
(resume, watchdog, preemption, deterministic skip, elastic re-meshing) and
``loop`` (``train``)."""
