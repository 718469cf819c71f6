"""The benchmark's plain reference: the lamppost emissivity table and the
ISCO disc image, in plain PyTorch.

The modules beside this file are a frozen copy of the port's plain code
(the lock-step march, the Kerr geometry, the sources, the redshift, the
bins and the disc areas) as it stood when the benchmark was defined, with
their imports pointed at one another and the definitions that the two jobs
never reach left out. They import nothing of the port and
are never edited to follow it: a later change to the port is judged
against them. ``jobs.py`` strings them together as the apps' ``compute``
does, building its own rays from a job's parameters.
"""
