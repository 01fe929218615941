"""Distribution: the error-feedback half of gradient compression and the
sharding rules (``sharding``: parameter specs and the group-of-32
packed-axis rule, which the lint checks). The ring reduce, meshes and
sharded programs are ROADMAP A15."""
