"""Host-side native code of the port (ctypes bindings over csrc/*.cc)."""
