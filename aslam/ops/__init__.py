"""Batched compute kernels (replaces reference Features/ + Odometry/ and the
OpenCV/PCL/g2o/DBoW3 native dependencies with XLA ops)."""
