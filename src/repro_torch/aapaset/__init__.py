"""AAPAset's artifact helpers (port of ``repro.aapaset``, in part): the
content-keying and atomic staged-publish recipe of ``manifest``, which
``evals.artifacts`` addresses its result cards with. The dataset build,
registry and loaders are not ported yet."""
