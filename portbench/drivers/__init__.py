"""The modules a traffic file's ``driver`` can name: ``train`` (the ADCC
trainer). Each has ``check(traffic)``, which refuses a key it does not
read, and ``run(bench.Run)``."""
