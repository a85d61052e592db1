"""Serving engines (port of `repro.serve`): the policy engine
(`serve.policy`), LM prefill / decode / `generate` (`serve.engine`) and the
continuously batched LM engine (`serve.lm`)."""
