"""Kernel rooflines, one file each, named as the kernel: ``PATTERN``
(a regular expression that the kernel's name in the profiler matches) and
either ``call_work(sizes) -> (bytes, float32 operations)`` of a whole
call on one call's sizes, however many launches it takes, or
``work(sizes)`` of one launch, which the harness multiplies by the
launches a call that match the pattern (``B``, valid ``frames``, features
``D``, emission columns ``N``, states ``K``, durations ``Dmax``; the
neural families add theirs). Bytes and operations are counted as the
inputs need them: valid frames only, each input read once, each output
written once, a multiply-add as two operations. The metric
``<kernel>_roofline`` is the least time these give (``peaks``) over the
kernel's traced time, in percent."""
