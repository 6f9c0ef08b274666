"""One reader a per-layer metric, each in a file named as the metric.

``read(readings)`` takes what the cell's driver (``drivers/``) recorded
(its spans and counters, and under ``--trace 1`` the device ``Timeline``)
and returns the metric's value, or None where the run holds nothing for it
to read; the result line then leaves the metric out. A roofline share is never reported as 0 for
want of a reading.
"""
