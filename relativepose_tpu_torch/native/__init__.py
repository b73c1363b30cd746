"""Native libraries the port builds from `cpp/` and binds with ctypes."""
