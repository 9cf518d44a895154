"""Host ANS layer: model search and the prelude (.ans/.states/.pointers)."""
