"""Mean share of the paged pool's pages that the live requests' contexts
fill, over the window's steps: each active slot's context in whole pages
(``serve.block_size``) before the step, over the pool's pages.  Pages the
pool holds for no live request (a finished prompt the prefix cache
keeps) do not count."""


def read(run):
    bs = int(run.mix.get("serve", {}).get("block_size", 0))
    used = [sum(-(-c // bs) for c in s.ctx) for s in run.steps
            if run.in_window(s.t1) and s.ctx]
    if not used or not run.pool_pages or not bs:
        return None
    return 100.0 * sum(used) / len(used) / run.pool_pages
