"""ctypes bindings of the repo's native C++ libraries for the port: the
token data loader over ``native/tpudata.cpp``."""

from .dataloader import NativeTokenLoader, write_token_file  # noqa: F401
