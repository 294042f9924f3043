"""Launch helpers of the port: input builders (``specs``). The serve and
train step builders come with later slices (ROADMAP A10b)."""
