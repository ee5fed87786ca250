"""Kernels: K2 and K3's least time over their kernels' device time
(`readers.lstm_train_roofline`)."""

from benchmark.readers import lstm_train_roofline as read  # noqa: F401
