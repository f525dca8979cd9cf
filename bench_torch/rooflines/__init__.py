"""Kernel rooflines, one file each, named as the kernel: ``PATTERN``
(a regular expression that the kernel's name in the profiler matches) and
``work(sizes) -> (bytes, float32 operations)`` of one launch on one
call's sizes (``B``, valid ``frames``, features ``D``, emission columns
``N``, states ``K``, durations ``Dmax``). Bytes and operations are counted
as the inputs need them: valid frames only, each input read once, each
output written once, a multiply-add as two operations. The metric
``<kernel>_roofline`` is the least time these give (``peaks``) over the
kernel's traced time, in percent."""
