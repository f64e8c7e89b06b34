"""Plain references of the program's policy families, one module each, found
by the family's name (``models.make_model``'s): ``shapes(kw)``,
``init(kw, generator, device)``, ``forward(params, obs, product, kw)`` and
``flops_per_sample(kw)``, ``kw`` being the configuration's keyword widths."""
