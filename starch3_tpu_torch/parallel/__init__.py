"""The port's block-encode pipeline (``pipeline``): device step,
dispatch, drain and driver on a torch device."""
