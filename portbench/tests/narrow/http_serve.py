"""The narrow CPU copy of an ``http_serve`` cell: the training copy's
networks and weights, at most four clients, and four served notes kept
and held to the reference."""

from portbench.tests.narrow.train_cached import networks


def overrides(workload, config, tmp_path):
    clients = min(4, workload["traffic"]["clients"])
    return networks(config, tmp_path), {
        "traffic": {"clients": clients, "reference_sample": 4,
                    "keep": {"per_client": 4 // clients}}}
