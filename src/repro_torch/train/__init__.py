"""Single-process LM training, the port's counterpart of ``repro.train``:
``optimizer`` (AdamW, Adafactor, clipping, schedules, over the reference's
leaf view), ``compression`` (int8 with error feedback), ``checkpoint``
(the reference's on-disk layout), ``fault_tolerance`` (resume, watchdog,
preemption, deterministic skip) and ``loop`` (``train``)."""
