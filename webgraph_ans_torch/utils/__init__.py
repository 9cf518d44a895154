"""ctypes loader of the native host runtime."""
