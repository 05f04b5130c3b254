"""The benchmark's own machinery: finding a cell's files by name, the
seeded inputs, the profiler trace and its reduction, and the frozen
yardstick (peaks, operation and byte counts)."""
