"""Host ANS layer: model search, the prelude (.ans/.states/.pointers),
the raw symbol codec over the native library, and the pure-Python
encoder and reference codec."""
