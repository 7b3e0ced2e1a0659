"""The n-party star: transport (net), packed secret sharing (pss), and the
distributed transform and MSM kernels built on them (dfft, dmsm)."""
