"""Host-side index build, the single-query engine and the anytime loop."""
