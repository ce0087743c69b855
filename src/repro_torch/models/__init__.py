"""Model substrate: embedding lookups, layers, attention, MoE, the LM and the
recommendation towers (serving); submodules are imported by name."""
