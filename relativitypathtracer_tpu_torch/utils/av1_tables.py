"""The AV1 specification's constant tables that an intra frame reads, intra
block copy's, palette's, CDEF's, loop restoration's, the quantiser
matrices' and film grain's among them.

Default CDFs (section 9.4's Default_*_Cdf arrays), stored packed: for each
table, row after row, the N - 1 values 32768 - cdf[i] of an N-symbol
alphabet, as little-endian uint16 in one zlib stream. `default_cdfs(qctx)`
unpacks them into the rows the symbol decoder adapts: a list
[32768 - cdf[0], ..., 32768 - cdf[N - 2], 0, count]. The coefficient
tables keep their four quantiser contexts until `default_cdfs` picks one.

The default CDFs past the skip flag's: palette (y and uv mode, sizes, the
colour indices of sizes 2-8 in 5 contexts), intrabc, the motion vector
CDFs (joint, class, class0 bit/fr/hp, sign, bits, fr, hp; one copy a
component), txfm_split, the inter transform sets and use_wiener,
use_sgrproj and restoration_type.

The other tables: Dc_Qlookup and Ac_Qlookup at 8 bits, the smooth
predictors' weights (Sm_Weights_Tx_4x4 ... 64x64, one after the other),
Dr_Intra_Derivative indexed by angle (zero at angles no mode reaches), and
Intra_Filter_Taps[5][8][7]. The scans, the block and transform size tables
and the small lookups follow the specification's definitions, as do the
inter transform sets, Palette_Color_Context, CDEF's directions, taps and
Cdef_Uv_Dir, and loop restoration's Sgr_Params, Wiener and self-guided
ranges and x/(x+1) and 1/n tables. Quantizer_Matrix and Gaussian_Sequence
are packed at the end (written by tools/av1_tables_extract.py), with
Qm_Offset.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

_CDF_BLOB = (
    "eNrsvGdUYtm2Nrw3OYkSxQSCgiAIKEFQQVHAhGACQVQUxBwx58qxK+eqrhy7qrpCV+yKVu7KOedc3ZVzrn7t2+fe0Wf0"
    "+fGO74zz57vv2GMvdM6515rP2mvN+cyFw8CkHlWrFBEpF42J2B0uZQ9lfibY8d9QPll1yv2S9WKCKE4wKBzFGR+M9wnF"
    "mOA7rE/Nj7hfOC/ZSvZ25pOAU34VXr7Y9bC3KWeSDsaPkifIlknuRK7jWRj1OCIyClyWKTJ4JY2NN0XvjhzNJQRupx1F"
    "z0ewwcvWPslEYYJgazgt7CSbx7oauBL/DCWFL6y4zvQJPkKn0lUBh/wP0zhkEfYc/AT0iZNkFEWiRKsiZvHLeFNCq4Pf"
    "Eovw91DLi+brtyZpVEAcTElTTIjawmDgRyGEkNHOypT2pJ0J3jEkUXB4XHC9PwX3GYGAbjf+mtYhwIVf4p4MmxHKpPcF"
    "zMPNR2+A8PKd6Zuj70hrJBmRPNEZXgZ7Iem+lw55uXxGmdW/2Q/it4smp6oJLT5fUZuRKyEsS3j2dN3WOFfsF2Vf9FP+"
    "NtZp/Ho0DEIt6LWNjZ8Uh1IEyQ7wZ/jH00ZhniMjwYPGPcmDkiSKZfJx0jdRZkEgHcDFIsvBtw5omjZZpLodG6EMVLyR"
    "tAWdxaUhVoJfi77aSnWU2CVKpGKI7Ab/LiMRPwTzDHKjZEXBufz7apN6nur3uPXy0b7p6FOwF0BL4aU8Wg5f+0b9q7JA"
    "lhiWF/A75iMiALxhnJU2TaNW98hMQglnRuA0v0/obEQIuDT/YBpN90SzJGawUMPLZV4L5ONsiMdggSO2UBy7TlElbY3c"
    "FrbUfx5Nij2A+gz+aL6ctcNg0YxQjVZ+lTHCLjNO4gqRdFDtXODosb22PEhiRI/mzPSG4YfDD0LXAt1t1ppGJypsCvU9"
    "GtpGq5pfqAldRB2Bjmt8l9uTViY9zz4CD6jj5J7X4lWbw0mE6I4sc05ytyQsrNJ7ZkuCNdaEj13Av41KaFuRuzhprPhm"
    "GNb7caM2z2x6EwOL0KBmha1g3gjcF9DrX0HLoj4lriZMw4Qgw6AX83+nLqbmU4nUF6SlpEySkrAbNxN7DDrWprOhfW55"
    "r/Ke6v3KawjWiT2HvAm9C/k5bUvq0hSvoE8BgwPm+7+hOHxqUMPhJPCabZpNbqPbLgTmUI8QccQfCUMRAGwaeDLrcdqU"
    "tIo0he6u11ivZ7iX2GSECH4FWJiyJzk4Pl19JGZSTIcPCnMVvRi6EnQDqzKIGb06/6RDid2JpxIU+B+9MlBhUAmIyFqc"
    "diI1WtubNDlxuKY+4b6PAX0aWQxOlQ2KmisyCJ0RbMHQcE1YJzvJ24zOgqii4yVEYVAETvBLeCpvPdsvNIdqh9dAelX7"
    "ZXcjx4mniyZFzBHUhgu5l/xzaJugSzI1aZN0DboSnUznr9urrdS2Jdo0rHhbniL3+4yhBjBtYcpx3aXE8ZoxkV8jUrk1"
    "TEPdjqjlkehIqXh9RGSETPAjr4A5llFBvYUrr/5aJYo8I3aIeWK+UMN/FT6PncAczDjsu9oNlhKdW1MUyfF6vW6OWqV4"
    "wU/kLQ4dwxxeg6q+VGGosMiWiueHk3gt3PX0a4Fm/w80RLWve72L4XqQPyKiTIDkh4RLGRcCq2mXKOLa+TXXXE7XvkJ6"
    "YfRARNoprGFHhHQET6WLy1a71xYtL7hob7Z/tLXIx8n6uQXsUlYYY3IF3DWnJKDwsn1D/kObKU8oZ3HnsrWMLv8Cy42c"
    "T0ZXxrv0X9K4qaW67CSq6G54behd+gPLu+wPxsKMXekRafaUHu0dTWekNYwVQgwYZ1VZFhqRGZvT56edTTmgfZIYKkGI"
    "maGjgrY2MWvCXeucec53JSNLBhVfctyy19oeWkbhtbL8wBT0zNTGqGE+VNPgEL6P1bZQDg0gJcUL4cFrfF+Qqr0duGko"
    "JxRbcj23Xh3DLWRF0O/73vVuxV6p4hs+aj+IVnANwfGBwX5jIbNbOOX5RcOEr9lyxg5aOkmFuBOdIlzNBsk7CSPx63F0"
    "zC+w9yXfFzzKLKbvD9jm9zO1jTgMP7jiZMFP1uDg3YEmmobaST4NGd9Z3EZuifHpwj/ANWB9MW5oXuR5/hX2EFwT9ih6"
    "PyoXSYZtdO9yPsy/RFxGmOtzEZ+Iq8AcqiA4Sx1vvZPwR7ETMcvQRMjsbm1XZCcLUQRfCQNhbdCNIJx0gDDBJxC8D0wD"
    "BgORZT+VbnTsh7Aha8Bx4NGqJ25h6X1IEOQpsA1Q9sR013QlgA+AGUAFAHbOLcbaI43mUBPpWM9HDyl/jJmpTCQW92Q1"
    "LWmMyuJJf2CXVO9LHZw0TOkXeg79c52+4mRxZt7igPFeUZ319Th7vmVr/BlSau9vzWrPWnerUh6S39VWj66tyj4kPhT8"
    "uItbryzKsgqiK73kfVWNLbW9Lj+VmKXp5dYXug2FrZoTrMe9z+s6qqML18aDvLWe/VWzLIQkPwmN9VN7dpo6eXw8J+QE"
    "aVvvksJLej/dVukicmBvhfNWybRknmxP2OwusvZXzWBVsfBndGMPprav+mHFj7xvlKedB8vSCzfbv+rKAw/3ZlVnVgW4"
    "KZqGsHHdw4t/ciBy2+LO8gN6Sp2z7TPyTqnH4Cf3EV2UEkpBnuZm6LTeK8VNdpPldWJZcHkf05lZLLbJtPciUz3acleu"
    "n3a49EJIWdlxg0Qy2+//L5+zul5l4MKWkuv7ZrilWed9p/eClc7sVeq+3ilad3QA6mHfvOZFbJC0v29MXUB2Kutq3xdP"
    "VrJC4OrLLCdn3I4d3bfHPT1D4HW6z1F1ywgXvO7VViByN7F/7CNUMbI2xmW2G6rQWeOi+U6CKA/OAOuBTMAApABaIAGI"
    "AxSAFBADAuBu8vEQP2ICwgZpAf3AfcBUoAMoBYqBAsAK5AJvsqdy7/oMgi8G3wJbgTbAAdiBPCAHMAHpQDIwmWqBPwAP"
    "/IteuUAosCBO7k/zbkBtgXdBh0B2g62gGPwCnAL6gbXAZKBOn83PCICSFuAXob8g5kIbIC7wA7BmQNMA1ABA1MDF9MkM"
    "xfxxY6MHIfUZG7V/3ETmt4CqyoicP+5CtV/Y69of3J8r9CUfjUb7KFNIisD4M3fAlf+56MZBeZ/F6cr/+o04CmIH/t4O"
    "0gAZg+SDtIMyBsX93/y8W/VzXKzzr6MMlUG5u9P/KjGJ+1RnM7ZkvEr5b0m0KERUp83TrdP9t2Q+60LchYTbMd9S1Ylf"
    "Mv+QVLL2CDfINiWwYvpTqFl/SD6SlQmVykESbxGgmCnJt84p/J4+XwjPuqOWR33TQmJ5aau9J4euCh+Y+gSF6rnRGjec"
    "O0LwV0/+vPbEgpGLc/4qmSQu5NP1f5VEidNEH5M2q3b/j3QO7w2PE23RvNb8t6SN+yTiRqJX3JQkUuRhyR+SUqaYuyUm"
    "UL5DSlaUyv+QdPgvE++MYUnCot1xV8KbYl8lhtFCBGLxzzHrpD3aLWIldzueRLuUs1KdGd8rDAzNj3Kln2P/3efLslui"
    "q7q/SkZE4qSdcX+VqGQEwUtZtrBe9t+SX0QponpRhuzV/zw5Mgoi2BB7XmxS3Az1/6+5echrDb0ZuVnEE5oi5Ul/SF6E"
    "zuJ74l/Lxisx8lTmQ1WKKoL2E10SvSKqQFxie5CIwdQzxlDnq7NjqPIDEml0elxxYm/Y330WRR4VXhH/VWIVjBaOD/2r"
    "5JV4dwRPtpurifxviStyvUjGf8RN/x9sAVGnRSwBjztbsoY77b/6Cw7Lph/gbeVvjNHz30r/kKgFK7k/R+8U+0adEegj"
    "FNL9lq2MsfRA0XzWY9HK/Ei7C31UKvZfw3NJzop0sdT456KzsvKkv/s8A/qlYl1mVvhu8VqyH+jvfC65hfG13UCPheyH"
    "ve6os75Ql0TH+T0E7ldlKo9j/nzmM+Zl1Wjlq5ASLisgFqJupGmP4v/RX8yD9vGu5CCzeRdsIrCy800iBF3X96Y6D1ZQ"
    "PrZvdseENiDBbL6M/qsHheg651zDS6GvUEd9DRld9ZtyFOFPzRXoufZ4S1zsGP4QciO4sy4/IfkfGhf057zBSn8Giv2O"
    "eAkcXd+cmP4PzWzfx12p2ZNFI6LH+6uhkVW7BVFefT1IXiicS9P2NRYqg8s4o1ELgL96kI2bWjAsY41kS8x5hhH1a32Z"
    "5lDAnxo+1NlUnytTZkVaaXgotfmtfmfQn5ppYJylTnY1eERwBSEP0t+4OVHj+6dGgkI1NmZHy7dFPQ+dB/9SfVt+zOdd"
    "E0b4FefymdTUGjPS/6hvCqkH/KsHH6lb3CPzbsTG6qK4DfjyllVZV4V/akqgsPaZzgf6IwkzmfsQ9BZ9ru4fKwcCEh35"
    "ccuYI0LGerdAJnr2GbL/sSZTYR/a6NkCtSy6hQGDn6qVawYxXrUf1aOCjsO8HQtEAElK2oxJ/icPtna/7NK2364Z31vS"
    "s7R9dF1W08oabn5Q8sT2B54fSw7rN7ShW89W4wt/74H27GxXlfOdD/IzUgpk8a1AQ1HhfFVmw80aU+EonbRnbdfKlq3W"
    "ntxww27Fq5BRTdaaQ3nno465IYVl+rG8mK4HbVm1J5JGSz6Fa/1fY/tcL81bpDcIDb0fekTdR9o8ZcK+6t7rnZCmCc6N"
    "Lab6AuezLJMY0TGtCeNenDNZFtLN6ApqP1x/03yoN7l3U9ec5vFFcsfEvKmpNrnT/1nLvXps8ew0CzOiVdf8fR29OE+z"
    "t+do97l2Rs1WQ2l6VkKb+HnQfK9wz5CqrLxR6nMB72s3VEIcL9IWsru78juWNh60HxBt43GYvdTNWBD2tKTe7BaeoTbD"
    "tvTiezd0oTrim34qWd/L6cnoHFN1vDA2w+RJqZ5txaQ9idkcer+jueVNTYl5vF7MJXfld0raBjXCyg6l1/cu7vnc9bWF"
    "X7nG6Cj6znJL/0C+MmwBvqf9cBOl0i8/NiWUuq1V0OJXN9UFZCIk3r0Xuq93pjQvKX2YKNf5q4oER+gw4iekuqGuHG7t"
    "1LEiNvkUlo913sv0T3gYFkZ63/mitacBU7IlJYhZw5waMJXwI2YT/CTkt8JlJpF0DW0lJgpk99F7v+s637agsbnignFc"
    "r67Hv4tV+zH/mXF57NDqW851GeTE3ZHDWFzyp7YGD6myImWXYrJokG9Oj71b3FnW4qwdX3REGta3oHd6D9jWVO1t64+d"
    "UpyQ25bUImlmvSBzkJ9a++tPO6t1b5W3hLfQKzvlHczWipoWe3riTsa83jM9md2KltEufurT8ANpYxIkkVOCzxEj0aOh"
    "PeUOm0k/jL2aeBf1AmzwPK7Z7Yw3rYrmBqtwY7pVHcqmx0WipMk8JgHJjPJnENwYb0QZdDkoKaAbnBE/oaugBwYS4JHe"
    "rT0L2z83PiovLFqRcy3Rv/tge1pzYFVSXGbUOA4hkNtqbeqvyC+8aayKxUfNZLrbbtS/dXpZckV9Ie8DhlKsnfvaDteP"
    "Lp9glxoeKb+ENvbCu/kdrGZpnj4pIsxJ+VYmKF5vDNZdku/hrKfFe7V2GJpmV2ZZh3IRIVhGKPJ507qGqgqcXZ+SF5Uf"
    "gMLv7zrSWuz5Vs3OSVXa/GdhETn0tK2xz4QXg/GUY7izcHNZa35p0q7wAvwU5DxoHBBYHV16LuuYZhmv3HcI+jW0unVE"
    "XWH5lsJl8RrOVvwB2Db2Y8YXCsubh4lEFsMXQV5ZobHLguKJG+FXILVgKtDXw+se3nikCmGdrPte/l2oxF/SVFY223bc"
    "MBCRJGWc2X7HcX41Z8reWC+k12t2KVOFz/0E+L/bRHX5t5lrFpQszMJrOyUfGBu8/24z3wW3yRJPSJ+EX2FNppEJO6F/"
    "t+lvWdCwriw83526NyaIjSDMRvzdhpBl0ndLrvGcTEFAAeW613jI320uV/SVmM2f9QTpz8xLPvmI/f/CZk7EV7Yn4B0p"
    "D/8EOxLzPVLwL/xp67X3Enp+6FjRJC6/mT5YeT7MP6CweVuFb2Fz1mmdKOY74a8sve9i7Jb2uPbxzXX1Vy1l8dMFoym9"
    "Ppeg/8oupcfQvaVpWyU132HQxSwIXxLQS/xXdhNbPjaOt2tVsWGhzBLacGIYoRT5r+yCW9CNfaUPLaC+VD6OfdD3rNd2"
    "xL+ym5FvNG2KeSU8y8tiP2S0BHoF/AL5V3YX3B5HclZdIifyCOsC2eM1HXHiX9otF5VxGYEU32qit/cZ3D3sJOxB4F/Z"
    "5cQMxhfjwuHDkJ3QRfQn+LGCzZhTKBtogU0BEnFt0FWVU2j3UTzYXpgTIsZ9hfUbc0lcFAOyHLke3Am3gYiOHUYlqg32"
    "IygAcxHLoXnyQ6w4eC4IwMaCt6GvAHhHYOtEZDZsHdQCdEEOAalpbN5ySDkopb4gTvNaAyR1jPQMQWig0eAcoBRsA8zm"
    "VeF/vStiE7B+uH2w24hfIFWUIxg6jYygIbYBS6FDgR5UFKRDS8b+CF8I6YUYwQYkDGrzQyHzEQSQAbsHJEPXAKtbJgdd"
    "gajAwUAqkA/5BFyPe0Kiw64A98F8QA89DjzpErVdR2ZAxZB0AAeZBWwXLPST4GuQg71ARBhuEoLVe6H9LsILug8UAPXI"
    "9r/5NyzyCNIP9QTiRsyCIHyqkCMooxH7oZOAp9AXQBQcAfYpH6I4sDtgISQM3AtLgZCpI5BB0JXACkg/sBNSARzJsONf"
    "gGcANxAGnAC3AN2BTnQeJAtggiYgGTYCQLbMkUogk4E1IAe4AJ0JiMJM+GXI6eBezDigH7UXsHUf8WxH2qFCEAc0I3//"
    "m38MLgsRBCOAY2BrQQMaAw0gLYBZIFzADckE2JBEQCTYiYiEBoHlkBOAN5wHySdnIZ5ABgHzIXsAPCQSeBM5GMWGrAK2"
    "A2rgAPQ2OIN2HpUFRgBxkLnA97AXwM8MEF06EKcEoBi4Cn8L7PJ5DquAJAE42ErgV6gC2Gaqp8+F94EjABwgQ1/7m3/q"
    "BnphqrFIeRbbBT1mfON3F+VvHxIxlFpQflV7W1DSyi8/bNOJ1qCSoV4Zb/3SMLzi7XI5o6P6coYi+kvzFVd57kBhmwAE"
    "/39rRyU6yM0oeS4+ZJz3gYoTqVjJ6Ppp9p2pz5v3lm2yVkuS0YtgEenNfpfQEEdidEIwtXFW3mxNdOfj+mb3yLBt8EQI"
    "SY+meqNHOq7EfAiNap7iwBuBzv11L1xruD9hm+E9+kGBd7yeu01p/tFP2jorp9v/OrqzfH/87+EA5wSMDS7RXvP5ALtm"
    "LeLM8+kqY6kloULPClugblhwD/Q18F4D866FqW3LOSd8BpdtU7WEPKu/nLMj7t/B7ht5AimCFOltxAdwvYMTWU27V6HS"
    "csJz6/dkk2IuBj+EbAe8o8sxSqjAGshLIY+uep0cL/6uBe2i5sxmhEO3ALHRQuwP0Bo7TiTzu1l7x5StjGlhuw5kLw+c"
    "B+WD0+QzvDLgoc7M2Esh6zxHCpS6v46eUrfCakodF5gCj4KExDcQ5yEB8xbOz6Svpc0J57m7W0rdFy3xzHNQL9BH/QrX"
    "AU3LYtHXYMkld+Qw+mHPlsLO9ISwcbA2cKIuhDgL/tWm5j0iFpdzEz9zFzW3lnRmVooLUT2Qdak1FBuywn6E/4FysmKM"
    "bnDEtJZDrsM5RSwifAT4OO4K9hkEbpwf+BrzuCBYctV/VO3UnE8qJvMoNBXcow7Di2Frzd9CjnrvKEuLf86e1FpUdiUP"
    "T2sBawFn9A3UWEi3qTQAguU5D8o7GcnNVcUHTDh6P2QH8ECZibkHQWWV09Vei53hCh+muWlD4dP0P7FXV/SoY8NjGFyY"
    "BUxU5/isQ0y3nONMJG1wJ6lvs41NwkJcOjEwFFIKBEV3opmQb8arfsdRgY4gscn3Xm23yapIIk8fiGjnZT0YKnRPTgqz"
    "FL/AdTjmF6a74YX5YsJV/x+gfmB8vNmnFi6xhob9Rsh0x6i+hAxrHGL1157yfwA2AO+jtiKfgE8zevxk6GFFnaK3VFw1"
    "JdVLLKClgXbgOyESsRqsNX0f8BLjVbRcuIC6qM6UOTYunJIDpgDDBL8jXoB9xrQgFxZVkCR84VtWczn9nJxHYYLRQJXA"
    "F9ED9mby6HVYbslXuV/Q3to1GfHyP7FPqgrNa05bzG8kCFF3c+PDp9Iiii8orZwR1Z8N30fPb19RjSmu8u2C/AQYYobh"
    "foVasscEe+HHOC8rWoJNzeOLb5tGE7eC6wF2dDZGCO3OPBhUjVtTMi9axSjwMAsWpCrJHyAUEKpK9/4NFpKjYmm9n5fk"
    "K+uYX5v2FOszpxLooAfIkmxC1IDXUodRziG68qfw5eQ3Nb2ZuJiJlP1gP/BWhkRvgpzKSmIN9za6nih+Zmzy3LbfTnmJ"
    "bQSYgCmiCO4As9L3UkjIYYUZfBY5u16X41Fd894FsIGKyPdwOjgszUleDpfb8dxffTpqggyfJH9iv1jJSgElLX4k1DIo"
    "0egX4ibZCkwicUBw+bqEcIGj9b1rm/k95jgQCXgUKqwEOj9HHZzjFVpSK/kYUNSwyKJPisUdAX8ERinCsLuhxda3fLQv"
    "sRqfYhHDmy2OG+lkn3CwAOiNPT6wr79P/Ua9gwLyjnJCSDtcb+LH8n9FZgFUgMXRwnxBZ7KB1IBItD7nJBDmlZu0xyPC"
    "ArwgYkAf3QHfDuakOgmdUGZmPq0Svjx/Nf+Gzz3CcEAAnONNAblAmpKOegF8l5LgDUL9MxMC6pETmVMg3wEzFd44NjTE"
    "WhkSjBOVHIq8R8qtmKUuYv2J/XF1SukOxwnKIvxi7Bv3I+OuxGFtV8sTi2Z3Hfdk1Ol613ZGtQX5mxAGMDv9PmOnz9Qy"
    "lD4m6qBnQaG/AdFJr/eUKnHrINeAh5pi8hp0c9H6yMuBD2vup2+XJrTx3N8snwmxkM8AKGKj18GwKQsZ50hgzTtjU8yz"
    "9t1V2x1khAAgA7+E/ga9CWzQG8k/Is4VOYXtlP2NQuv32n8niv7ftK7WOaVuew6jGPcOgbAvltVzAU+/vT+Z0bm84VCV"
    "vSe0M7Mlg0UciCf4dHjweq+d5aHJhRF7mkLN7xN7WnmlhTk74E+AK4Bd70ILoUfrlmSPjN7Rc62+zFXSkWw9l/IL5sHA"
    "jjgnLcV8gebmLmKOwz2rHKZ7L93Vhq35UDQRKh3AHsjJhO0HhqTd8s1FRRUfk5D8XfUy82r1fxr78oH65XbnVfnk0FTi"
    "qiqg2GyObXyiNQnut6wtuZQ5vU8+UBO/477CVkH3FyUKB/l7GvOMhcrVHYrSJnNYj7bN5onAcMBcYJACQAPQjBwnLRI3"
    "ukKrPS7Qt512+xZSkSbIASAibgTue0R4fgL3GfmPcT0CdsfkYiA3AcEawB7OFcF54M2M+wEXsDtKg+LWsC83pRba0v/T"
    "2P83t+UVP2Ud1swWJyPhkNUpkb6fkbdsNlEY7UXZDF1QRFUzobTF/DLEA4dAenWPyHQkx/672OP3zc1KPiza2BBQlJTx"
    "74xuVc7AzYV9MngFjMSQC3VqCs/fWWA4qpxTuTFvVPJCTil8PGSSdjmRgky3Y6V19PGeVTYf7YrOBQ3dZVWBNyFVYLf6"
    "ABGCktmxylD22JYNzsdZ5E5U/TeXlsaCz4HQVG5qKabb4aN9KJ7U3l8J/Sde97HogOxU8NuQx5AlwJSETzgNNNCiYWV7"
    "bXePil0Q/ENDljlZHe13a4AT/xbbiFkImZp7h0HA3XeJFelBY2qPZYyT/jvYr3CKYUHganU8Lhn6OA/JOeo9tjQzRhz8"
    "tWZvKkQgDKqBUsD6mDqvR7C4/LWCCFp+bWnGLdmz1jGlT7IHBWZCbwNXlTKvBhi5YILoFm1rrcP4TTqn+UPRsPRZtAOQ"
    "vcCD6B+wdqjY8UHyvX9gY4j5yD+x0OHurLRXMf6MowMVnTh2NL4Zfji3gz2XOLKMqDnGlbasc3ZmG4MmgUOBybLlqCzI"
    "tMxhQZOwjS68chBju0dagEjt9hdD3gFDE3y8r8A0BS0CMuWXyp06lMDVInMGZs1kT4LqwBjNJp/FcEiRl7iaNry6O7VR"
    "vK/F5jqd/cZ3NTgG+C1yM2IVqDMg/acNZIrdkr3+U2p3Z1fE4QKugduAOpkZNR+iy6IHv8VvLudp1nCvtYrL9HkeYj+Q"
    "Bugj1sIvDeSgrX7ZWFJpZIw55Hnzb8VBmXtJL4BsQC36HvEGHGoaTj/g9cR9W3WIXdXc5Bj9j7WqKWqRTgleHbx4gLHP"
    "UXl7XYJicy3MEPxCNz4ulFXkmW37QWv244FyoFGSgNCDywybqTnI3xxTRe+oS2sfGr6XHiPIQRdQFD0V/T0kIndF8Akv"
    "kRsVu4q5qHFEXqeGEdAOmQk44lzYx5Ck3MrgW7jrpWNjVgWnNBZYuhK4FByoBsYLyXA+GJt6gORCfCnA8RNJ+6q26FUR"
    "CX5kUA8ki2sGarHxaSspVtSrAlzEPt/W+vrsKyqH3xxQCSSI3sGTwSUpYyhpSI+tNbyFcq5anb5NOsdXNpD3QaEQ/hJ4"
    "adhFW4pEFY+IHOOrqlUaUqP+xN7jXKTbHr0sWI64DR5MHu97Fh3imCeZFuSsHZYxX05qz65EF1T4TgUrgXPylxgdFGqm"
    "hhi8d5W9VoWHBjYnFk1Lf+S1baCj7yPbkGJIUBaU7h5AtzJmKDOnqbEgNZVJEQ3MTIi0CpUNacky0ltwV0rfxLxjapof"
    "Fl0ybMYXDHCzlbwZ0H5ga/IMYg58Z0EW/z5xZW2ncb/8F8ILwAJMEN6C7wUFRl7AYWyTc4J8KT3dsy+/KTkdkwUEAb+y"
    "86FfAVhyLbEUMbSgnr+bbK/vzJ4Y9xMuYyCDZHB50DnAC90JbwGMmW/gnPPeUXMm/cw/eN3usr2qFP6koAewmWCa/jWl"
    "EXXRnihYQl1auV47IvynpqzCwrQp1E+gBcDFeWNXQYbnbKevwI50dcmlgVWNay3hmltY7EAN/WvsZ2wJNN52gdNM+FCx"
    "OekYb7YnO9+uj/EBwXigQJqN+ghuMXj81OgThV9EW2kP6n7IDletRpcANOBJ+DgYFqSmpJMOwFvyD3NnER7U3DaMlH3y"
    "PwyEAAeFJyCHgaVxDhQEEmQgk/Hw2PwvYRjv8+TkAXTL6J0DazJa8AL2CPgQfxO7ApqbfYxeg+9j3gCZQIh8EOI4IM0M"
    "8zXDKcXrwsvwv7gGxemC/sT+qSnVXWR7nUoXlwQ/qPCkDJI+aLifZ9Efa7nkupF7viur2VobFuCEPQea0+h+JnSxqzz6"
    "Cv3H2keGjdKb7V3VxQ651wFwIvAhbgt+ELw3f3b4F/L9itLEbh69ZW7Jy8y9XuqBNfNB7ovdDH1l2RLa4LOqfFz8Kvap"
    "lkfO5OybyJgB/zv5IBwNtmX4+1YhMcXfiZZRjzbezWtL+k/nuGHVYzLfqT6JqL6fsRtLmhSpIcM8l+zLDIHtK6uvOt63"
    "99UwS8zU8dCnwHeaFrIbFVhAFiz07Su/EYcKudbUYs/Vf4/4AFgBpXIVZjr0S14yZx15dS00dYt0cqMruyZ2KmY7IAae"
    "RhxGjoK4s3CMGV6RpZDYa8HIRqElM0EIZQ9gn8EiD/D54qRS4hE4NCeY4/Y5WZ6bXC36T2N/24Vu2V8/3cBRyoTtLb5l"
    "xwsXd+6uj3Vv6tK3TK1d3Qvt3tNxgROB7oC4876F76WOqR1tEsU1tlpL51tkXV2NwytgxAR4IvSpajrJjtYWQIR7aHsr"
    "3EmlEdrWEten7FZUCOgEDkZ+xayDCXI3hkQTYWXDVUkcVPOKIq+Mh9A/+Hw4z4YcC8oz0fTrWKdrkPx94OIGt5kW///Y"
    "13+uTSicm1Al2hByBfoS2K6dRloOz7Z6R2AoT8re647wY5vYxbONX+nvIT7g0PjPPkthEvM7/gNydMlBzTremyqx+Yzm"
    "3xn9vfAocjFkgXYVpQlJy2gT7gyAZvpFx4Sez94S6y2o8SNC+8GrSRnEYYhXtudSFCOpyZX/LUkxUD9uckaSAYgUDFO/"
    "JR1Brs8fr4gLITcHFP6aEtD+W8UB2wb8S0g7+DrmDKkRiSuQxmWw57Yucb76Jxb6i/kS7wW1JeDQQJXdHgfHhEAW5pyh"
    "K7BXS2fF7KNr6p9kVSpppPdAPLBIdg/hBJ8Yff1OITc4KFFu3wuVu/UW/r+D3ROwBywB5ki0iBhwe/pr2nXkWCtHMM8X"
    "WaCWRPsGUXOgmWC7MsQ7CMG16gXNvsdqJ2SckfS3PivlmtZRnZA5QFz0UcxtCNJq4W4lLKy6on/DL2x6aearTpFSQAPQ"
    "H6lBpIGwosWCBz53Kgn66+F/HZ2W74lrjmj1/Q0cCUQpDLhN0BZzRuhx7/ByZfzr0MwmZ8G+lB2UfYAOmB41E7kFhGXf"
    "ClqO+bF0gjKSbm2U59E1KykA5DQA0xIIXvCxhW6RidpRtSMZHTG6+Y4DnnGePgryHOjTziDw4a6iZaJj1MNVG5KlEcbm"
    "aofNcJGwBNACJyPC4QrQbpjj9xa1x5EsTfffVXPR6JEv8E4AxwFIyXzUY8ix7Ksh+wmlVXpdjKC0lViakGPEThvwaix/"
    "ISIawjSZGf34tvK38aFh2U177Y7kp9gJgAJgCa8j7oOM3NEhnd7DKgDNas5cz3DbkX9kkA+5C3kW32X+c0A7QI/BoWEQ"
    "Z/aRoFHYfveQ2A+MzgEGVRrjQ5gEUIDcCANsD/AlDUaJQlxwvBKyKNE1fqkO4VH89YFVgYxejyJAbOa3zNlet8tOx71m"
    "UhqD86jxGN8IMB2YL5uEXAo+yxoe1I+huecqW+nP6jaZTslacc6B/D6a/XHgDUZooT5a2Br7+rDJ3kDFRU0KJ4roNcCL"
    "tvHDkC8hPCOecdi7vmyk+ht7d+McS7z6K+ESwAVW8UhwMTjTMChQg+lwwaKHBY6srkxlC30Iowd6XsE7CV0KYNNltCHI"
    "7SXVUcd939dEpeIj/sS+1RYUuzbiol/TwH5P1ElJdxCvCleLxtA+VMNSb4g2tnic1VklZBSYBHQqZmO+hwRZh4WW4X8q"
    "J6unsjo9dFtr0mXMSEAEmKNuI6MhXbmjmHO8npSdU7FC+j0Pba+0J31mDsx/axQRhYP4mbmsy15V5b3qOyG5TTvtOck/"
    "YyQDcb6UcwsyHpCnPCJ6w8cXrRe8IxJr16ZHRt3F/ASkAt5iL2Q+hJdzP+Q64V7FrcRDPF6zq2hlugWRMcDrdrHJMC3I"
    "Sxvv64fOLXkjiQx40vBdLl995b9OhDaE/HFy5dZHEM3w+UWIiJVkVh3JOFz2J3ZGAVEykcHw94ZOARo1W/HnoWcsrSG/"
    "eW10P1TOYWxsuJ27Rt1PODIwh6WyIkQA6GOC0UqQ+0qOij9Tw+vOZpyRkbBrgSjgU8xQtBtSn3cqhOQ9t3xqQge3vaE6"
    "r14TRjgJ0IF8qRJBB1+mX6aMQexy3BR+pCys9Rh+lkxGqAc83M5xQn8GbPoHBB18h30yV0sQVa3QTg3vITQDVKAtahrk"
    "AIDXq33veO3K2xUG+PDKaHErQp/ilwC+wMOAm2AnsE0O+JjhN62dodN8otx27TjeUBYUDAJ4UR9ho4HBWTZ/F2p86ZDI"
    "7yiTK/TKsf/Y7zPr3uXkJAVFVOIHwey5rJBKn/GusQol80GNv8Esm9feXRVRdN+3HdIBXNEvIjDhbwovC76SCVVBWlT4"
    "uJYnJWMyv2FeAUYAojmCr4dtK5gg4FKuV0XrfxUMbvZ3TDPMxS0HOIBEaUJHQ9LyHjDv4XaUrY8dE1zWLClipycgZQPY"
    "9aImuDcYYnrhG4scUVwtKqN01PtndSv/0zmOYy0XNQcqKHz4ArDb1B/c7hPsVClPse5Ufk5OjLrfuCLvThIDOXPAHBF9"
    "EQWFIHNQQXDMQydMes2vtw6eESP/DWIciAZ10VdRdRDv3K2hPJ/XlXtVHl59jSEHGj8U/gdrPcX/BEOBO1PvkqbClxas"
    "4b0hbKvenX5HMhUMHNB+pBdCLw+w4mneYliBaQuzCPe4/G6ShPufxv6yZYJre64xtVd4MFBZLtbJJSPq1mTVq042T3Ng"
    "TP2dUxrQ5Q2Mj3AZeNH4JvAF5rVrm2JYsKNmblpOVFhru2tVtgALg2wFXscG4n+AOWy5vE4SpvJ24jQepCWs6G26H+YX"
    "IBpYEO2FOQnxN99hhOHOlmKVjUEGT6d1atJzaPAA9pMRC+A3gEfGqb6JiO+KfUSrSD71xZmhiv/Hvv5zbVXpivjTXE7w"
    "Z7AImJbWRrwO9RSpRQTy0cof9dDwnxsttnGJQ2lFYB2ASnB6LYPMs4wMu4D3KX4WR2AGVFUZVbJ/Z/R1LCf0DmCIRuO8"
    "oGMTntB3e1UnrguzkVOjhjPGkL0JAkg0aNGaSF8QNXax8k0wpe13B1Un7epuiC55ieODU4F9ylWEUnieuTdykF9J49Es"
    "RvS21pH5cxOXIITgcGC+uBsXBH1qvi0mUCktljzRP51ZzbSv5CWQTFQxKABkCfvRR8H1eYNZj7Bny/vjLzA/N3abR8nn"
    "4ScOrMwH0qewTUCN8SI1CNFWulHiRT5dcjRRwP53sFcQJwz0PIm7CeICDiVxqJ+hkcqhtCOUVVVAwqrwn4hLB3bTHFku"
    "NhDqykPw7hFnV/SlwQRAB+AGdFcIWDAKuMO/CTsEzMntC9qNuVz5RHvZb0stO/Wq/IX3DiAAOBW2HlIN9FiG8gyEOjs7"
    "NZX419E3lxxTDeFtC9gMZgCnEy96IaBVNhTbH/+0LEH1IvhpA9zcqLKQfwT4gC12GKoR3Gn+RJ+DFpRCovf7D65rMDZL"
    "GYRQ0AHItRvwaqhv4SR+EWFRhVfSN861xvt5HxIaKGLQDaCTaPgvkJ6C0bwd3ivKUfECVmTDhJwPMde8xgzkR7UEh4gC"
    "ERkKv2nIN/ZO4Ubyt/Kz2ojwMAwDnATsjxvstQuWatsj+EbtqPuWXiN+17KkZHmGFDnAaIEbEghmGiQ4N5G1xGuC+7pS"
    "Rj9Tt974SlqPGgcIAYt0DOo2GJa3M4Thdb4sIPYb/WqtwdAa+Sd2Y9Fp8Uy/H32rQCUwSzUSfQdMz7ke9BP6bVmz/PeA"
    "erfF9EjMwloG3k6eCA6bDqzPGEpaDOOWoPmrCc3Vv+nqQnZ4rQXYQKYKhr4Cuizrmele7WVrYrNYu2vGG8ZG+hI/ATIA"
    "ruxHVoI5OUsC4ejVrtnR/X536i+m44V6RPhAz74cFiQJeJ140usMxGxfHHYJ965UHGuk53u/B2cD2AF0mdCo3FbuXaKi"
    "en4KgpNcszajMGYJmQeygNURV2AngUKjxo+C8C3m8A8QXBVR0iLqDNL+gey/QNgJbQLUhlCKHnal5Au/CHvRla3gBf6J"
    "Pa7ks4rEj2eVQScA8cmHiWz4Wsca4QiKs3qt/hPf1txSyEudSNwLhAJ7Yuehz4I+VpB1Cysvu6EMpRc17M5eGEPEjBjg"
    "V8tjN6NfgVirKWQeTlF+IG5U8PuG9FyBqsznZyAcmBArwhAhedbXIWqvw2VJccODdzbcyB2kYqD+yO8X+Aug8wBKehI5"
    "CC4uhPKrCblVNN0d3h7kPSAH6I5dgTPAMq2hghLf7wb43spITwux+IyhGJYN+AMc4RjE2oHsPC8gCNPuGiVt93tVF5CZ"
    "KV8MixjoeahgHuw1oDD+7mtHfnTOE2+jrq59m974j/deXhKvuM184PscTAS8Et5jNJDTuc+YSTiyWxD9S6Cn5nfDJWkr"
    "tmygn5GSWfCDQEhmE60Ocbj4mnAP6WzlFc1TtgvzBBAD09ThGBikyooJBfAllacSvoS8q8vO6447hhs/8GxalAX+GvBk"
    "aKjVyDJHcMRrcm6ZRnWcdR3CHNDmcBZBpwPd+lKfe9BheRrWBNyS0t+jDwe0kx+DecAelQqxAILJuxhy8L92q5ntW/jH"
    "32ztJH2DzAIYuuM4LQzIHdjDPldb//hubbzrnsIT2OPDh9QDx4QbsATIMHeI4BxqW8Vp3a+sP+KImfKPWFcRnHI0anXY"
    "p4FKqiH9AWUSYnfxosh22qnqhyn3hFtblpbMN5VRV4CxADXRzwsK/S0fFZbn/bE8Ue1gdXkOW6cnpmEODaz53xKJXtHQ"
    "xIIZ4QcJLytnJdaEbfacs41NGu+zGWACXqpl6Gsg1+rHwuKelr2LETK4Hm+rOHEO/I813yoC4beAORlrKQAis8if/5bg"
    "UzMp5Y3wP53jYnLnRcTTfvD+daCOXppyirgW9tI2nMPH89ysmGv0BTULDOOkcxDVAx4qpGzEV0BspPr2I4yONbwsn7VV"
    "r5MecEWwPzh5XEw8agPIMpEZG7yulRtkdQxTDTn9srIf9sc3rTXhD6GTgM7ki4QNsMf5MZwEH7l7RdwW5m3AB8ABLOZ8"
    "SBmwUnPT6xGEabUwP2Gel/YpjgX8p7FfrF9o3pVYHDOSOh0Tan3D6SFoK/ZopvDeNCSbM9XSNkN5rdUn4AWkCvisnUo4"
    "D8uz8wbyhbriljo1FNMUYV+u70XtHYjVceqJuHHQ1fmvwuIIjvJValzoKY/Ntk6r9JoxEHNk8uXIetCavdKfiTrnfC25"
    "77u9YVHOd6qNsD94nUU4HLYC6DAEkE/C+gtf875482rupliE/499/QdrmRSiaDITZaqXkEI+FMp0pyUPyvfkbE7qrGUV"
    "IkzsxmrXCUtxB7bpY80vyYSowLDpGiNb7evOfCZZy+IWPEq8Li4tnWTsVj2qlOe1Jz9pGVSz0TUzs09pFHDTvEWO4NVm"
    "fmxzuMExNblEPrzsa9YgTVi1xZaQxmkOrHxVtFAzkpPtx0rPFn1l3MoP1RwW7Sl9ZPyowlVPs8alfq4zOtZmyVu31Zxw"
    "oTiN3lzkask631+xR7TJnDBqQ45JPi8kvXBF0gNxXOnRjA+xHfUzirk5k6JG0ALxcvkW/y/4c4mq0IvkcZn9UdZgIL9T"
    "Xc8nlMSmjJD1V+mtM1K2JQ8RLgo+lcWWb2fvdhxKHicPrIRb9PrhdVeKxFm/NV4oPWBVdKzxpNQsSv4pch7HN2kcZ5Xv"
    "tkyr9CtrbkFw0hXxD6UHjBWqY5W/W8KSPzXvrUoryUtcy78cbFY0BU0nDNHxuI9pJTnIaD92SSFGeynSu/RYxpC44Y3D"
    "SiG275MS+EMDWzNPSivZTwszdN3Se2Up2d80B2s22mEZ5+tflnzL9WorrYspa4i6RO3GflVGB43yjkkRhyf7Oc1cZT7H"
    "z8HUmyXj3PDMTjW1YVvJltzmKI7/QDUvhfjvw7cl7Ga9JIUby8Sj6JOsclV0+EHHNT1cuqr6ue1I2k7LjITjUbtsVZol"
    "UYvceVmNiXNr6AVi4+eGt84eC6U5tqK38HbntRZMIzH3Sbyv5L6JKZeF7bMoVRcFiuK01C0KabkwR5K0sTo1f0X62dbs"
    "Ol3Zw/QL8t386VKev9B7nQYXOoYy0sSKmhx8y7ZL3STYUdyc0iu/UD++RGQeYz6n5gsT8odoUdH+7g2Zp5LCauMKn5vO"
    "NCJKN+eFNt8tM9s7OoKbNtbA03gyPEecVSBbx1ZbDsaV8E8Vb05xKQTuTyaYpqz6RsGOjNzmlkqa41HUr758PFYe7v8L"
    "vjDxA7ufssi4OFIQHGdpi5XyfrfXaldGhtfssJ8w3m/9qXFY9abmwtrfyzF1SufvtgRPkptQsNzjVzHVfrHlWlWYa0VP"
    "dZe4A+X0N+yLba+fWHLRPLc5tjrA9ar1S92H8vVtxQ3GqoPtVR53tai7qf1+80zFzuBVRHJiY9gWv8epPCGfcTr3jHIC"
    "z1iwN2l51B3ncsOp2AseZPnRAmHla/tK8/vWQo+hPq2ZW7HV+V3rr85mG6f5dJHZTG7wLWSa93btag1qwufPjgsVLyzq"
    "TQtSHak5XdCZdbN+qvOQZX+rq2pE8YV2jkdXFd+5pPlq/dmk6IinAZsSE8LjaUUZCNkc5q08TcwEXnNRvpYoohZt0J+T"
    "fKopyK82/G+OdbW6xYIcxmzDbvFDBqmQpS2IKi9/nK1JFNVuL6AZaxtnuHosh9tvNlKr25Nlkp+5+ep5zCby9xkGcRtD"
    "ZffR7BM2lJYbYSpr1dy8YcmtzVsrBzsyTZXK6YIRSQDX6H8lc7t0awiy8ExSa+S4Ur1xRxxY6TBf04oaJ7si8yKSuLzq"
    "AEvyz/w7gRJrvGo3v8aFNcBjKiuLzSu1FbWqglsGU/NPFdsKB4X6eR9EXhY+I61BL4tfFtxCSDUJIt10tX1WvEYw0Xkm"
    "bX50Ss34fFL6vIgyyn7sfuE78maMO6Yp8CL+Wmp1+CIawrw32jcUWXhI4xCeKvNkbYsfrEngzQhEZDyJPMisK3qhM0rr"
    "K37O7dTK6yhFB0wrGoNK5+dNbdc1KqpyE5cImljJajNzMmlLhlFMZYzJpyTMjkhxlRu2x2ytIJnXaYublpWfLqhPJItS"
    "2GOkXf4/eOclHWGfpHqyz8qWh8ALxUke8QTXCcO5mIr64cWZOcd1jIjU4Mj0A2ICi29fpGkSn3PvNL1RB9fQ8mvSaus5"
    "xRHZnhZcdXpJWFggAYN+K35HoWMfaQpDsOT+rCrpTmZRwX5Ng7Df+TpNr0DULMg/mD5FmEz7gscKyRQtdmwMOmiCd0Ka"
    "lJ/sxzQTFNtDVxXkJEaJ8BWa3D1JpPQ3UWPYO7KiFP48QsnxtCkxk6tKrCNSt9WfLt6fc80zvSzCvrdjRdOuWpPWSxgQ"
    "slQ3i7fAf26On+Iex1H0XmeRrnVXZC6I7636NS8tJbu5rFLreCi2Bz0k/xQxhHwSE66uDrYQ+zM+iax0qm2N6ll4a/G3"
    "5JkyT93tot6s9lSH5CzHk5sUR44glhZkXImLqH5mPZ/6c31/ycncCk9AWXb+0nZF45HKfvn+AB/vrap3jCFEcfqeCEYQ"
    "P48T+4GrduQl58pWuo8bJ6pM9dJiSs5MXgbpIfpHEYuixBpUOxhI4on0KGFI0AXzWaUt7EjBtcSF4o2VLyyO5C2VRvOU"
    "xHfFIUYvTb17aea8hJVVldZRKYvrNxV75YxuWlWeYL/ZtbytuemG1azyEghcV4zb4w0Vi81fk6k1xIK3Rm795uJJud81"
    "Hik9anN1QJp+rdkun0cfQvKJfcLII43TX+NZ/BXZBXIYu8m+TnNW1FuSnHZDcbnB7lqRt9KhN5zQHLfAE/3kdQX0xD6R"
    "yR2ZsStOVuuTPze1viHFNSq3oqPX46muzJgT7qHtt+Vqjont5eTc33R7qrvsvxmv1l11BOacbLxZOszyolHjzrDh+L7E"
    "02iylE8bhfNLaGOeJLalJvFf+j/KhkQ/CC21/xTPFSIq5Ll3kv43x7p3CZE8e6CX1skN9fPkL1CvFijKvDLfqmS1Yjsl"
    "vaCxr6Q0J6qNUkd1L9HuF7exmxRDA6/7LEqt5eMDdlghKkr4JufeNHf0q/LynB5NdsOMElyuQrcpoj/4geJbYJsPK+Ur"
    "D+f3g5mtHMJ+WzgocZtwovND2sToq1UL84qS8XHpwWjSc82w0JOUi9lJsr2sxY5QfXfUgrK3mfnxhbWz86ekPW3Mdhdb"
    "K/i/kFCYjYK3xNOorDhU0Hb8jPQugcm/xvo8dhe3u8iqM0n2VvJz7scfY67GcuBnWSBuFmxsJIscimZpXwaX+FzJeiGh"
    "MkjWjGgN430JK3m+eGXCVK4loCvlF0FkELQgMtFPDC8nZr9NMNcGFbwzkBo3OKPN2DZeXYvbK/G64A0rUPEt4Ig3NiU0"
    "fJFfjuW5MiFshuOEHi1d5p5jgqoD6w84ENk18YP57mCd6BUlELdCnRj8krAvwy7CBS2xiuLquTLHEh08am6lztKvm59c"
    "GDGdvksv4EcHqmwp6qP8baWwjEMx56s+WuQ6XK28IDxD2QQvd+areckkF+aVkEYZioWoYQyXj8ZwT+AKOGKdEHc9rKVo"
    "rm6W+HXltJwa7VteJ/kZ9iCbg8cisqMklH40MkkV4iGGZc2PnEa35y9VjA6JdvqmKWSzk/cKHzI3GL9KD7G9i8+m0BUX"
    "Kj9bRiU315928LNHexa5f7Kp2yc30CrXJfzIm0cvjw9jxZPJRpf4Ov2yLTDeKvhUYkljKZLKF2Uv0cxpqHWuNl/n3CE/"
    "8xLz5vn8joTFLg/09v6URhXU+XdZDinLOAVFau1FsV8VPO+L/ve0FVH57K0GQdQ+VpsDqZdJ8RXBZpFuc21Hob9pa6O3"
    "a4nleQulBudyc994j0SZhLNJOkxw4lmmnvTEtC8SGUyz1quFgrGO4Sl5MndFca5MO4Qd4P0boiUcS7iNJCko/l9xfdrN"
    "bC6lxYgSK4KiLD8qJoQmFQ9KfiBdV6DWpyjgttmJPKlvyaLUDkVQZdtAtvKuCygaqMYbA12XzeqORs/W6vtZSYr0MHdO"
    "q1LEk9udiU/F45yv05Gxy8uP5jxKel6dku+b7mj2VLocvIjJFAVuqURIO4S7mLCHdYH0JIMq1tN9rIa4GN5PRQpdblRO"
    "jdq+13DcZIrLjYxPT41KZo+2nVLt5090KQy5ipm1D61jkt/XUUuSTEeaYVUHihdHFgdO9unRLuLc9EvOwEQtZR6x/a52"
    "C3zstIRHQqW7OWNo9N3KHZYy3S8Bragq6IWwDPx3iAD5Ydoc3A7N/JDppK8Zc0Q9QZtzP8rXhX4tvpq8T/a/Oda1KBjM"
    "EnK4+gtTRyq1flR2sXe50zKWKo7WzrON16MaA4o/mSgtwoq7dqTqTugpX6joFul7dLGmKbjXpyt7aCSSvtl+Nn4b77uS"
    "T/pXkbPLlpluxpr4q0kT0WO53+Hvwn+UTfPtwNTqZSFin0U5F4S2QC9zuXIIU17g0bWJTIJTRAPaoyQGTMcbsvKiaIwr"
    "JRU6nHBbJSb3ZcKNmkEFweqFjaPcPVkQthiTBdsQrMAugZ6Voqh9qDrDhKhrtIPZ86XVrLZib8MIwaoqs/lmlB/lECoR"
    "upUeiYqDXmef89kJ70+eHiJC70vdzLITyvRlHAnpj/N/M2WegsTAk0xJU9jDqb7279U7w8+5haYpccNqWm1jUprrI4qH"
    "ZB0fqLWjigJVPWysf654FTkOkxR/lLHRR2KcLNwcgLSGx9zgbCgK1LaIW8onZg9OwIsbabO9nrIxeB7ioWQw5SZ6XtL6"
    "EF/iINMg0eKAx3lLlSHsdcV79EKJOPYdQ0yMT/wa+pTy0iyXe4ecLslKMcm9K6qy8OreOlr+a52k6Z7zW3Yup8PnHTIu"
    "7D3eG3k9WuDXjDMafEUnA3JyU2JF3LmONAUQ3OCckdWu+46+BW9GbA5woyohM4R5voW4DfprwQifbTkXQw4QOIUW/XLO"
    "FAct/bAoTJUeEk09kOIUTA2cWVSm648iVE7MfZY0q85aFJLZ5IG46/Ii26LrhrhPKX4JzqEuk670zcat0EVyTlH8cz/K"
    "hCFrCn9PnCqqduUaflSSai7lp6dPCttL+IbOZNd6bYL3yFp9ldh83Rb2bnJRVn1UJiPcNijuHRcsXWFYESNNFIaNonHS"
    "q4WDgmQOS1KgOLvspgmW4FudkUdL/lwLcSw2TfRgSrNsqczheBRiNq+M6ECPj09gBBBGZaRGPPSjWnTRHwJl1sqEj5xF"
    "9sv6SbxW+iLUIQiDgcEKYcXcqz4dyMmydQHNuF+SYRwJMdIUIXzgW2aaLZ7t15s5Xz4qTGL0lkBCuovitSPED8sDskvi"
    "A2uz7O3ppMbbJYuzDW3IOmepJqGaMYqwJpHEvkVJMzaIefQU22gVN1xc0pxCkY10wzJHqJrrPEWhmSI2zTsIeTDiC/EU"
    "6lYsLOgxnpL6jZdDe5TDky9jqezhCQZBZ/mO7K0aV+rcSD37gepeSIkv1LxQZgsOcbWmrIxiVXnnHImTV0hyzyeSG2Wu"
    "DuuyiLNUCu6VIMKnAsFVrKQFoH/TDeFwqRuN9yQbB/ZdXvwzzhu3OOVa5C+k9QgJtIvxAHMOWsBf55UHG61YQR2BeRk/"
    "O7jP620ynqMgrjEtinL9rz6va+3c1HYvPUCxhJpKuAJiC2nGA3FjcJgqfkmI5pDCQeITHgPqlCOKu2Gz6PcwPcgVYAf5"
    "Z5/j3hzvJrADsP3T/0BKhfXEB9dpYUs9pC4r9HyzoHs9dKvndfcdiK+nvfsomOdK63wPZjV4d6rBd8V9fRLQR/CiWJER"
    "oPQXpAYe8goqdeXsTFghGR+SR5xaEmvMiXsigjPH+6x3+KRuU+znE+hjfdKNZNms8I/0/xN2A4n8cRRYChFa2EXlPcQt"
    "wxsdE6RFwy5SK4YhZxa5Dvdd9TEIFlcMnQXwATFpK0PjI70WaAssBLZuBFSxORUs+RoKDWRzCFtvRVc5BSjkFEhxSl3d"
    "TEQ6ISi5FWB2/V7DTYArSxx1EAt7xWo/V+01PCv3GtoPAEDHVmQWjQQbE+YI9FKfG3Bm5gkWJlgSVQN/ARwcchKjCvpa"
    "qiuIFbBjKxeACyE1WiBDEVgFrwMGAjUftRZgELYJI150MPchQxJhb1MUPw2lBmgyhiOkF6YMYgRrA20CVgGkJcEcphbt"
    "EIcK7WKmPBMvRh+yEmRn4h7AFpAPMQgcNpEmTR3VFCwM2gXCBMADxQKfAb8lkR2gGNwT/Q6SCdpkqUP4NWcnIRxtEHhi"
    "TiRuHL0VBw8MCJA3myh3IK0ZKRKjCiIGJQVKBHYDhQJ5AUcrtSK1HRAZjhRlDw0KFGXnQ1A6mishIX8X7A3taXIlLh5q"
    "GLISMA1MB2s0zieeIHYafBSZDhAJzAbaBfAEJwRJA2cCeAFfDgBA9123DYYEVx0nDgFQYxWHZMgSTzHDHHAIaQRuIdkV"
    "MQtgWY4oshXzaDsakw1yOHgpUxEFCWAGSgM8JnkcexPeCiNfYCzlHjYPL3f3DH4IkgQLNS4txRo0EJwD1ALnAfoANykJ"
    "IPMX9Q+sCHVj6j9MM8gf+BCnbhgeARfyDjkHxjzQL+kkghdyDC4IFwdcBQkEMQIJLYAlLB6uFt8P1ghvZlxFrDnHKmEc"
    "4w+IckkZ0xTgD1IKLgXvQW04OCuGH6AWBgz0BhwGCQUKBBEDuwE+LAglSh96Gf8TzA6dCBlpq0VwO0QvfSPVGKcNqXIu"
    "GwMXqhLZDUYJfgTTOYwxKClaIl4ZDhFKCSoGnwXkBEEErwPmAr4BvQhbENoikS4FIew4m1CZNnlVA1XVFdwx71NLGJQ0"
    "cEiREtYrwEf7EX8oKEGWbkhq8WETWu5LO0Z/O9YwACzAJoIifhyxEw0PWQiTefN1Vm2xaYFhUl7mVgNE9jpIMAsoTh4U"
    "FkgP4wf+fIt2l2uVTTVCETbHK+chHRiSEL8IAEC5bzJ4FH3OUik+O1vLJwBwAFSANAAQAAeOA8AB2QBwABwACwAGAAEA"
    "AEAAIAAYAFAALcAhAGAAPAAtAEAAMABAABQAPAA6ADYAMAAoACAAEAALAAsACGmnXww=")

_CDF_LAYOUT = (
    ('kf_y_mode', (5, 5)),
    ('angle_delta', (8,)),
    ('uv_mode', (2, 13)),
    ('partition', (20,)),
    ('tx_set1', (2, 13)),
    ('tx_set2', (3, 13)),
    ('cfl_alpha', (6,)),
    ('tx_size', (4, 3)),
    ('filter_intra', (22,)),
    ('delta_lf_multi', (4,)),
    ('dc_sign', (4, 2, 3)),
    ('eob_extra', (4, 5, 2, 9)),
    ('txb_skip', (4, 5, 13)),
    ('eob_pt_16', (4, 2, 2)),
    ('eob_pt_32', (4, 2, 2)),
    ('eob_pt_64', (4, 2, 2)),
    ('eob_pt_128', (4, 2, 2)),
    ('eob_pt_256', (4, 2, 2)),
    ('eob_pt_512', (4, 2, 2)),
    ('eob_pt_1024', (4, 2, 2)),
    ('coeff_base_eob', (4, 5, 2, 4)),
    ('coeff_base', (4, 5, 2, 42)),
    ('coeff_br', (4, 5, 2, 21)),
    ('cfl_sign', (1,)),
    ('filter_intra_mode', (1,)),
    ('segment_id', (3,)),
    ('delta_q', (1,)),
    ('delta_lf', (1,)),
    ('skip', (3,)),
    ('palette_y_mode', (7, 3)),
    ('palette_uv_mode', (2,)),
    ('palette_y_size', (7,)),
    ('palette_uv_size', (7,)),
    ('palette_2_y_color', (5,)),
    ('palette_3_y_color', (5,)),
    ('palette_4_y_color', (5,)),
    ('palette_5_y_color', (5,)),
    ('palette_6_y_color', (5,)),
    ('palette_7_y_color', (5,)),
    ('palette_8_y_color', (5,)),
    ('palette_2_uv_color', (5,)),
    ('palette_3_uv_color', (5,)),
    ('palette_4_uv_color', (5,)),
    ('palette_5_uv_color', (5,)),
    ('palette_6_uv_color', (5,)),
    ('palette_7_uv_color', (5,)),
    ('palette_8_uv_color', (5,)),
    ('intrabc', (1,)),
    ('txfm_split', (21,)),
    ('tx_inter1', (2,)),
    ('tx_inter2', (1,)),
    ('tx_inter3', (4,)),
    ('use_wiener', (1,)),
    ('use_sgrproj', (1,)),
    ('restoration_type', (1,)),
    ('mv_joint', (1,)),
    ('mv_class', (1,)),
    ('mv_class0_fr', (2,)),
    ('mv_fr', (1,)),
    ('mv_sign', (1,)),
    ('mv_class0_hp', (1,)),
    ('mv_hp', (1,)),
    ('mv_class0_bit', (1,)),
    ('mv_bit', (10,)),)

DC_Q = (
    4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 26,
    27, 28, 29, 30, 31, 32, 32, 33, 34, 35, 36, 37, 38, 38, 39, 40, 41, 42, 43, 43, 44, 45, 46,
    47, 48, 48, 49, 50, 51, 52, 53, 53, 54, 55, 56, 57, 57, 58, 59, 60, 61, 62, 62, 63, 64, 65,
    66, 66, 67, 68, 69, 70, 70, 71, 72, 73, 74, 74, 75, 76, 77, 78, 78, 79, 80, 81, 81, 82, 83,
    84, 85, 85, 87, 88, 90, 92, 93, 95, 96, 98, 99, 101, 102, 104, 105, 107, 108, 110, 111, 113,
    114, 116, 117, 118, 120, 121, 123, 125, 127, 129, 131, 134, 136, 138, 140, 142, 144, 146,
    148, 150, 152, 154, 156, 158, 161, 164, 166, 169, 172, 174, 177, 180, 182, 185, 187, 190,
    192, 195, 199, 202, 205, 208, 211, 214, 217, 220, 223, 226, 230, 233, 237, 240, 243, 247,
    250, 253, 257, 261, 265, 269, 272, 276, 280, 284, 288, 292, 296, 300, 304, 309, 313, 317,
    322, 326, 330, 335, 340, 344, 349, 354, 359, 364, 369, 374, 379, 384, 389, 395, 400, 406,
    411, 417, 423, 429, 435, 441, 447, 454, 461, 467, 475, 482, 489, 497, 505, 513, 522, 530,
    539, 549, 559, 569, 579, 590, 602, 614, 626, 640, 654, 668, 684, 700, 717, 736, 755, 775,
    796, 819, 843, 869, 896, 925, 955, 988, 1022, 1058, 1098, 1139, 1184, 1232, 1282, 1336)

AC_Q = (
    4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
    54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
    77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99,
    100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 120, 122, 124, 126, 128, 130, 132,
    134, 136, 138, 140, 142, 144, 146, 148, 150, 152, 155, 158, 161, 164, 167, 170, 173, 176,
    179, 182, 185, 188, 191, 194, 197, 200, 203, 207, 211, 215, 219, 223, 227, 231, 235, 239,
    243, 247, 251, 255, 260, 265, 270, 275, 280, 285, 290, 295, 300, 305, 311, 317, 323, 329,
    335, 341, 347, 353, 359, 366, 373, 380, 387, 394, 401, 408, 416, 424, 432, 440, 448, 456,
    465, 474, 483, 492, 501, 510, 520, 530, 540, 550, 560, 571, 582, 593, 604, 615, 627, 639,
    651, 663, 676, 689, 702, 715, 729, 743, 757, 771, 786, 801, 816, 832, 848, 864, 881, 898,
    915, 933, 951, 969, 988, 1007, 1026, 1046, 1066, 1087, 1108, 1129, 1151, 1173, 1196, 1219,
    1243, 1267, 1292, 1317, 1343, 1369, 1396, 1423, 1451, 1479, 1508, 1537, 1567, 1597, 1628,
    1660, 1692, 1725, 1759, 1793, 1828)

SM_WEIGHTS = (
    255, 149, 85, 64, 255, 197, 146, 105, 73, 50, 37, 32, 255, 225, 196, 170, 145, 123, 102, 84,
    68, 54, 43, 33, 26, 20, 17, 16, 255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
    101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8, 255, 248, 240,
    233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144, 138, 133, 127, 121,
    116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32,
    29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4)

DR_INTRA_DERIVATIVE = (
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215, 0, 0, 178, 0, 0, 151, 0, 0,
    132, 0, 0, 116, 0, 0, 102, 0, 0, 0, 90, 0, 0, 80, 0, 0, 71, 0, 0, 64, 0, 0, 57, 0, 0, 51, 0,
    0, 45, 0, 0, 0, 40, 0, 0, 35, 0, 0, 31, 0, 0, 27, 0, 0, 23, 0, 0, 19, 0, 0, 15, 0, 0, 0, 0,
    11, 0, 0, 7, 0, 0, 3, 0, 0)

FILTER_INTRA_TAPS = (
    -6, 10, 0, 0, 0, 12, 0, -5, 2, 10, 0, 0, 9, 0, -3, 1, 1, 10, 0, 7, 0, -3, 1, 1, 2, 10, 5, 0,
    -4, 6, 0, 0, 0, 2, 12, -3, 2, 6, 0, 0, 2, 9, -3, 2, 2, 6, 0, 2, 7, -3, 1, 2, 2, 6, 3, 5,
    -10, 16, 0, 0, 0, 10, 0, -6, 0, 16, 0, 0, 6, 0, -4, 0, 0, 16, 0, 4, 0, -2, 0, 0, 0, 16, 2,
    0, -10, 16, 0, 0, 0, 0, 10, -6, 0, 16, 0, 0, 0, 6, -4, 0, 0, 16, 0, 0, 4, -2, 0, 0, 0, 16,
    0, 2, -8, 8, 0, 0, 0, 16, 0, -8, 0, 8, 0, 0, 16, 0, -8, 0, 0, 8, 0, 16, 0, -8, 0, 0, 0, 8,
    16, 0, -4, 4, 0, 0, 0, 0, 16, -4, 0, 4, 0, 0, 0, 16, -4, 0, 0, 4, 0, 0, 16, -4, 0, 0, 0, 4,
    0, 16, -2, 8, 0, 0, 0, 10, 0, -1, 3, 8, 0, 0, 6, 0, -1, 2, 3, 8, 0, 4, 0, 0, 1, 2, 3, 8, 2,
    0, -1, 4, 0, 0, 0, 3, 10, -1, 3, 4, 0, 0, 4, 6, -1, 2, 3, 4, 0, 4, 4, -1, 2, 2, 3, 4, 3, 3,
    -12, 14, 0, 0, 0, 14, 0, -10, 0, 14, 0, 0, 12, 0, -9, 0, 0, 14, 0, 11, 0, -8, 0, 0, 0, 14,
    10, 0, -10, 12, 0, 0, 0, 0, 14, -9, 1, 12, 0, 0, 0, 12, -8, 0, 0, 12, 0, 1, 11, -7, 0, 0, 1,
    12, 1, 9)


def _nsym(name: str, idx: tuple) -> int:
    if name == "uv_mode":
        return 13 + idx[0]  # without CFL, with CFL
    if name == "partition":  # 8x8, then 16x16 to 64x64, then 128x128, 4 contexts each
        return 4 if idx[0] < 4 else 8 if idx[0] >= 16 else 10
    if name == "tx_size":
        return 2 if idx[0] == 0 else 3
    if name.startswith("palette_") and name.endswith("_color"):
        return int(name.split("_")[1])
    return {"kf_y_mode": 13, "angle_delta": 7, "tx_set1": 7, "tx_set2": 5, "cfl_alpha": 16,
            "filter_intra": 2, "delta_lf_multi": 4, "dc_sign": 2, "eob_extra": 2, "txb_skip": 2,
            "eob_pt_16": 5, "eob_pt_32": 6, "eob_pt_64": 7, "eob_pt_128": 8, "eob_pt_256": 9,
            "eob_pt_512": 10, "eob_pt_1024": 11, "coeff_base_eob": 3, "coeff_base": 4,
            "coeff_br": 4, "cfl_sign": 8, "filter_intra_mode": 5, "segment_id": 8,
            "delta_q": 4, "delta_lf": 4, "skip": 2, "palette_y_mode": 2,
            "palette_uv_mode": 2, "palette_y_size": 7, "palette_uv_size": 7, "intrabc": 2,
            "txfm_split": 2, "tx_inter1": 16, "tx_inter2": 12, "tx_inter3": 2, "use_wiener": 2,
            "use_sgrproj": 2, "restoration_type": 3, "mv_joint": 4, "mv_class": 11,
            "mv_class0_fr": 4, "mv_fr": 4, "mv_sign": 2, "mv_class0_hp": 2, "mv_hp": 2,
            "mv_class0_bit": 2, "mv_bit": 2}[name]


def _unpack() -> dict:
    flat = np.frombuffer(zlib.decompress(base64.b64decode("".join(_CDF_BLOB))), "<u2")
    out, at = {}, 0
    for name, shape in _CDF_LAYOUT:
        rows = []
        for idx in np.ndindex(*shape):
            n = _nsym(name, idx) - 1
            rows.append(tuple(int(v) for v in flat[at:at + n]))
            at += n
        out[name] = (shape, rows)
    assert at == len(flat)
    return out


_DEFAULTS = _unpack()
_COEF = ("dc_sign", "eob_extra", "txb_skip", "eob_pt_16", "eob_pt_32", "eob_pt_64", "eob_pt_128",
         "eob_pt_256", "eob_pt_512", "eob_pt_1024", "coeff_base_eob", "coeff_base", "coeff_br")


def _nest(rows: list, shape: tuple):
    if len(shape) == 1:
        return [list(r) + [0, 0] for r in rows]
    step = len(rows) // shape[0]
    return [_nest(rows[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0])]


def default_cdfs(qctx: int) -> dict:
    """Fresh, adaptable copies of every default CDF an intra frame reads, the
    coefficient ones of quantiser context `qctx` (0-3)."""
    out = {}
    for name, (shape, rows) in _DEFAULTS.items():
        if name in _COEF:
            step = len(rows) // 4
            rows, shape = rows[qctx * step:(qctx + 1) * step], shape[1:]
        out[name] = _nest(rows, shape)
    out["eob_pt_512"] = [p[0] for p in out["eob_pt_512"]]  # one context: 2D transforms only
    out["eob_pt_1024"] = [p[0] for p in out["eob_pt_1024"]]
    for name in ("cfl_sign", "filter_intra_mode", "delta_q", "delta_lf", "intrabc", "tx_inter2",
                 "use_wiener", "use_sgrproj", "restoration_type", "mv_joint"):
        out[name] = out[name][0]
    # the two motion vector components adapt apart
    for name in ("mv_class", "mv_class0_fr", "mv_fr", "mv_sign", "mv_class0_hp", "mv_hp",
                 "mv_class0_bit", "mv_bit"):
        rows = out.pop(name)
        one = rows[0] if len(rows) == 1 else rows
        out[name] = [one, [list(r) for r in one] if isinstance(one[0], list) else list(one)]
    return out


# Block sizes (BLOCK_4X4 ... BLOCK_64X16) as (width, height) in samples
BLOCK_SIZES = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
               (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128),
               (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
BLOCK_INDEX = {wh: i for i, wh in enumerate(BLOCK_SIZES)}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
# Transform sizes (TX_4X4 ... TX_64X16) as (width, height)
TX_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16))
TX_INDEX = {wh: i for i, wh in enumerate(TX_SIZES)}
TX_4X4, TX_16X16, TX_32X32, TX_16X32, TX_32X16 = 0, 2, 3, 9, 10
SPLIT_TX_SIZE = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)
TX_ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)


def tx_sqr(tx: int) -> int:
    w, h = TX_SIZES[tx]
    return TX_INDEX[(min(w, h), min(w, h))]


def tx_sqr_up(tx: int) -> int:
    w, h = TX_SIZES[tx]
    return TX_INDEX[(max(w, h), max(w, h))]


def max_tx_rect(bsize: int) -> int:
    w, h = BLOCK_SIZES[bsize]
    return TX_INDEX[(min(w, 64), min(h, 64))]


# Partition types
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)


def partition_subsize(partition: int, bsize: int) -> int:
    w, h = BLOCK_SIZES[bsize]
    sub = {PARTITION_NONE: (w, h), PARTITION_HORZ: (w, h // 2), PARTITION_VERT: (w // 2, h),
           PARTITION_SPLIT: (w // 2, h // 2), PARTITION_HORZ_A: (w, h // 2),
           PARTITION_HORZ_B: (w, h // 2), PARTITION_VERT_A: (w // 2, h),
           PARTITION_VERT_B: (w // 2, h), PARTITION_HORZ_4: (w, h // 4),
           PARTITION_VERT_4: (w // 4, h)}[partition]
    return BLOCK_INDEX[sub]


# Intra modes
(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
 SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED) = range(14)
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
FILTER_INTRA_MODE_TO_DIR = (DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED)

# Transform types
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
 ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
 H_FLIPADST) = range(16)
TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 = 0, 1, 2
TX_TYPE_INTRA_INV_SET1 = (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
TX_TYPE_INTRA_INV_SET2 = (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
TX_TYPES_IN_SET = {TX_SET_DCTONLY: {DCT_DCT}, TX_SET_INTRA_1: set(TX_TYPE_INTRA_INV_SET1),
                   TX_SET_INTRA_2: set(TX_TYPE_INTRA_INV_SET2)}
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT)
# 1D kinds of a 2D type, (vertical, horizontal): 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
TX_1D = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (1, 2), (2, 1), (3, 3),
         (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


def _default_scan(w: int, h: int) -> tuple:
    """Default_Scan_WxH: the anti-diagonals in turn; square sizes alternate
    their direction (a zig-zag), wide ones run each from the left column,
    tall ones each from the top row."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if (w == h and d % 2 == 0) or w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def scan(tx: int, cls: int) -> tuple:
    """The scan of a transform size (64-point sizes read as their 32-point
    top-left) and class: rows first for the vertical class, columns first
    for the horizontal one, else the default."""
    w, h = TX_SIZES[tx]
    w, h = min(w, 32), min(h, 32)
    if cls == TX_CLASS_VERT:
        return tuple(range(w * h))
    if cls == TX_CLASS_HORIZ:
        return tuple(r * w + c for c in range(w) for r in range(h))
    return _default_scan(w, h)


@functools.lru_cache(maxsize=None)
def coeff_base_ctx_offset(tx: int) -> tuple:
    """Coeff_Base_Ctx_Offset of a transform size over its coded (32-point
    capped) area, row-major; the shape rule follows the size itself, so
    64x32 and 32x64 keep their rectangles' offsets on a 32x32 area."""
    tw, th = TX_SIZES[tx]
    w, h = min(tw, 32), min(th, 32)
    out = []
    for r in range(h):
        for c in range(w):
            if r == 0 and c == 0:
                out.append(0)
            elif th > tw and r < 2:
                out.append(11)
            elif tw > th and c < 2:
                out.append(16)
            else:
                s = r + c
                out.append(1 if s < 2 else 6 if s < 4 else 21)
    return tuple(out)


def sm_weights(log2n: int) -> tuple:
    start = (1 << log2n) - 4
    return SM_WEIGHTS[start:start + (1 << log2n)]


def qctx(base_q_idx: int) -> int:
    return 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3


# Inter transform sets (an intra block copy's residual), the symbol to the type
TX_SET_INTER_1, TX_SET_INTER_2, TX_SET_INTER_3 = 4, 5, 6
TX_TYPE_INTER_INV_SET1 = (IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
                          ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                          FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST)
TX_TYPE_INTER_INV_SET2 = (IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                          DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST)
TX_TYPE_INTER_INV_SET3 = (IDTX, DCT_DCT)
TX_TYPES_IN_SET.update({TX_SET_INTER_1: set(TX_TYPE_INTER_INV_SET1),
                        TX_SET_INTER_2: set(TX_TYPE_INTER_INV_SET2),
                        TX_SET_INTER_3: set(TX_TYPE_INTER_INV_SET3)})

# Palette: Palette_Color_Context by ColorContextHash, Palette_Color_Hash_Multipliers
PALETTE_COLOR_CONTEXT = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
PALETTE_COLOR_HASH_MULTIPLIERS = (1, 2, 2)

# CDEF: Cdef_Uv_Dir[subsampling_x][subsampling_y], Cdef_Directions[dir][k] as
# (row, column), the primary and secondary taps by (strength & 1), Div_Table
CDEF_UV_DIR = (((0, 1, 2, 3, 4, 5, 6, 7), (1, 2, 2, 2, 3, 4, 6, 0)),
               ((7, 0, 2, 4, 5, 6, 6, 6), (0, 1, 2, 3, 4, 5, 6, 7)))
CDEF_DIRECTIONS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)), ((0, 1), (1, 2)),
                   ((1, 1), (2, 2)), ((1, 0), (2, 1)), ((1, 0), (2, 0)), ((1, 0), (2, -1)))
CDEF_PRI_TAPS = ((4, 2), (3, 3))
CDEF_SEC_TAPS = ((2, 1), (2, 1))
CDEF_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)

# Loop restoration: Remap_Lr_Type (RESTORE_NONE 0, WIENER 1, SGRPROJ 2,
# SWITCHABLE 3), Sgr_Params[set] = (r0, s0, r1, s1), the Wiener taps' and
# the self-guided projection's ranges and tile reference values
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
SGR_PARAMS = ((2, 140, 1, 3236), (2, 112, 1, 2158), (2, 93, 1, 1618), (2, 80, 1, 1438),
              (2, 70, 1, 1295), (2, 58, 1, 1177), (2, 47, 1, 1079), (2, 37, 1, 996),
              (2, 30, 1, 925), (2, 25, 1, 863), (0, -1, 1, 2589), (0, -1, 1, 1618),
              (0, -1, 1, 1177), (0, -1, 1, 925), (2, 56, 0, -1), (2, 22, 0, -1))
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)
SGRPROJ_XQD_MIN = (-96, -32)
SGRPROJ_XQD_MAX = (31, 95)
SGRPROJ_XQD_MID = (-32, 31)
# the self-guided filter's 1/n at 12 bits (n = 9, 25: One_By_X) and its
# z -> a2 table (x_by_xplus1: 256 at z >= 255, 1 at 0)
SGR_ONE_BY_X = {n: ((1 << 12) + n // 2) // n for n in (9, 25)}
SGR_X_BY_XPLUS1 = tuple(1 if z == 0 else 256 if z >= 255 else ((z << 8) + z // 2) // (z + 1)
                        for z in range(256))

# the border past the frame that a motion vector stack's vectors are
# clamped to (1/8 sample)
MV_BORDER = 128

# Quantiser matrices and film grain: Quantizer_Matrix[15][2][3344] (level,
# luma or chroma, then each size's weights one after the other, at
# QM_OFFSET[tx]; a 64-point size reads its 32-point region) and
# Gaussian_Sequence[2048], packed as uint8 and little-endian int16 in a
# zlib stream each, and the dequantisers of every bit depth (Dc_Qlookup and
# Ac_Qlookup, the 8-bit rows equal to DC_Q and AC_Q) as little-endian
# uint16 (written by tools/av1_tables_extract.py).
_QM_BLOB = (
    "eNqMvWdzHEe2JvxPhIYHGu2976521d577x2AbngPwpEwJAiCJAiQBCk6iSKlIeVmJM2Mxmh3Z2dmZ+LGxuwbG7Hx3rix"
    "n3b38/sL3nOyukDy3pmLbVFqFbMrqyozz3PMc04WZ8xZHLPk2s7cwWmxffonDmdIao3kJzn9I2KjJ1kbGlFQvnSpJRVT"
    "oWJnetlq9BXnd68fRTzpzu79J6/yydL09Sff/3Gy1lo+evXHf+b09PQN8ERaKhBOFxudxR4Op7dvlKfQOtzhVLEx1cPp"
    "7R/g8hVa2hWMZSvjfb39w1yhVGN0eYKRVLE50DfAFSnUJqs/mEgXak3eKFeoMFrc/lQmX6lNTol4fKnaQgeihfL4RGd+"
    "SatQaEzuQKbUnp6dW1nfprRao9UfLTUXlje2d/cOAw7a5U8V2gu7B4e3ju/cD7vhQpny9PLB4dn9848/TYeDwUR+fHbj"
    "8OzJy9dvvi2mYpF0ZWJu+9b9l2+/+81PjWI2Vah1VnaPz19/97s//a3TqBRrk/Pre3c+fvObP/3tnxenxpvNqaXtw/uf"
    "fvvT3/75f8Pz9/Rw+voHhnkCkUJroOhAMJxI54rVxnhndnEVxgM+fX39Q1yeQKrSGqwery8SS2by5VpzcnqOae/t6xsc"
    "5fLECpWWcjjdgXAslYUeJqZIe29vX3//0OgYH9tNDqfLH4qyl+hhmgcGhrk8vgTbaYfLF4QrZAsVaCed9w8ODo3A9cVy"
    "pcZoszs80AG0l2utyb4+bB4e5fKFYqlCozNaXW5PIBiKxPEOmu1+uPWBQbi2UCKTq/VGyu7x+kPQfToDF6iPD/RD+xCX"
    "L5IolGqdyWx1+gPBaCKVxu7rzfHhocGh4RE4W6HR6ikb7fRForF0JpMvVar1VnuGxx0d5XKx2UhZaLfXH0mlM/l8sVKF"
    "4elMzQh43DEeTyxTaimLzeULhOLZHJxbrzUn2p3p+WWRgMfnC6RwaxYb7QmEo6lCsVwfb050oHVxaUUhFYslYoVaR9Eu"
    "TyiezBQbzVan3ZmZnltaWl7f1qoUCoVcozfZ3L5AHG6rDt3Ozi7OLa2srG9tbxu0KpVKqTOaaW8gnMyXquMzs/OLq8vr"
    "V9a3dnb2DimDVquFe4fnDkUzpWqzs7C4fGVjc3t799re4eEhbaVMJqPVDs8dTxXr45359Subu1f3r12H9Xl0+zTgcTho"
    "m8sDz50tNNozC+u7ewc3Dm/cOjq+c+fs/lnQ63Q67G5vIAoT3oQVdWXv4Prx3Tsn985OH50/fhH2uV0umNBgDFZUCwZk"
    "8+D64d2zR/cfnz/7+PmnnyQiAb/PEwhF0/BoePrujeO79x9+/OLJpy9evXr9VToWDgX9wUgCxG28Pbu6cRXOfvjk2csv"
    "Xr9589W3X+eSsWgkFIqlMsV6s7O4vLl/486jj5+9fPX2229+/v33vy1mUgn4RTIN0joxM7e+fe3Wyf0X0PzVd7/+zY8/"
    "/a6az6aTyXg6i0MzvXRl+/rRvcdPvnj71fc//O4//vEPf22Ui7lsNpUpwOkdEOjdg+Oz809ff/vdD7/76U9//ds/jdeq"
    "xUIhmy3DWpxeWtm6dnjn9NmLN9/8Gpr/y9/++790mo1qpVws1OqTgA7rO3u34PZevfn5b/4jNP8///w/ZycnGo1atVJv"
    "daYXl7d2Do/Ozp+/+ur7H//4V2j+l/+1OD01Pt5q1pvtKTh9e+/w9v3HcPnvf/rD3/77P//L//4/q3Nznc5ke3x8ZmZ5"
    "ZXv78PD07MUnX33929/99Z/+5X/+r//z/3F6B8VUIN3gcjV0pFiZctsi9fWj23fSsXR78/43v+Vw3eleri02qImkxXS9"
    "TUXWNwPFo/vpyu1vGlN3fssB8AD81FD+ULpYby+AtA4OjQkUGrsjgHhJ8FGuMiI+5mAM5WKJQkd74plGqzU+M7/wHv5t"
    "b+5c34/7QITytbm1m8cnj0+fPc7GQoFYrjm1snfv+Wdvv/+unE0mAHZn1/buPPniVz/9hcMZkFPxbLmnt0+s9cWycDcS"
    "rTeU7BvkKoz+QGJgSKSzRmIp3pic9udzRZFA5YnWmk2NwhgvzU3NUhprprm2sua3+xsLN/f2Qo5ga/n43p10INHaPnn+"
    "pBjLjW8+/uyLerY0s3P69lftSnX++rPvf1oYby7sP/7uL4ifHBY/QQ4p2h8MIbgBtoA0rPR04bFvkOAfyLHDBfjYxb+J"
    "DgN/iG9jPAHgn8Zopx0gqiz+sfg2xhd9gG9RxLcP8EuuVIGYd/ELekeAao4z+CT6EJ+KFfggPM8uyt/hi/MCXyZazfHO"
    "zPz8/MLi38GXqenZmYXV5aXF1Y2d/b+PH9s7m9B2/WB/3+920LTN6fEhPtQRH67t7R8dHRzePj66eefsUTzk83ndgMiA"
    "TbXJuaW1qzePju+dPHh8//T82ZPHj1LRUDDg84XjyWylNj67sHp1//DswfnTZ598/urTz372TTYRA/EORGLpXKk5PrW4"
    "AiJw78HzTz978/br73/53beFdCoei4UZAW93FlY3967fu//0szff/PzXP/72D38p57KpZDKBo1lujs/OrW3s3bhz/8nL"
    "L7771e9++vNf/lorFrPZTCYFsFxvdKaWlrd3jm49PH/1+hff/+c//dN//R/M+pdrKT90ASqDLAauVGVwMzquB+d3VAz2"
    "hC+ESrEH1Rke06Dk4BSydrgSOPYGQjDpYG4MDnHFcg2MNxxnYOEMg4GhMTr9vkA4kemHhcSXqPWUJxSOQAcDfUNjIoXO"
    "ZAV8jiVTqeHBEb5EQ9mckWQyDUqMNzomkhtpsEfyoHiKRcEYT6yknL5QtlQpVcp1ESgflcUD9kmt1qw1G4x8huKZ+uT4"
    "eHu8owF7xeiOg70yNzvVmZ3Sq1U6szeZr84sLSwuzC1ROg3Ibwbkd211ZXVtmaaMVmekWO+sX726vbmx7XfYwZ5ptBeu"
    "3dzf29vbCbpodyDdnFrcOzo8vH7jKOR2gH3Tml7ePz67d+/OrUQAVEVxYvbK0b0HD+7ff5gOB4KJSmtm++jk/PnTJ+e5"
    "aDiUrjQXdg4ePP30s5evioDeucr46ubh42efvfnidSWdjBcrneWN2/c/efPNd7+ow/yW4GZ3jk8/f/vzX30/XixkK435"
    "xf2j81df//p3/7ldrRSrE/Or128++/T7H3/600yjUalPzW8c3Hny2S9/++d/WpgYrzdnF3b2zx7/7Ls//OW/rnQ64+OL"
    "i/v7jx598+1f/vo/cL77RvkKHdiLiVx1Auw/Udf+AxGbmPU7wGRAe+7a/tHh8c2zQioGarjWWd279/TNz3/8Qw/PX+CM"
    "OlIcLh3rEznDfQpfctSYyvMthZrC3e7o/AurjtS1PXdm/164cvQ0UTl8k6se/7w6cfPHidmzP1yGP5fhy2X4cRk+XCb/"
    "l8n3ZfJ7mXxe4D+nX2oIJXKsHujp7YfvSIrVB5z+IbHG/U4v9A/y1RRYiax+GB6RUM5kOsvqCQFP6QyVSmVWX8glulAG"
    "RILVG3qVOVldWpxj9QdtdBY7V7c3WD0SpAPNxaPDG6w+SXijE1fuPbjP6pVcON3cefDpS1a/VJLFzsb9N9+xema8UJnf"
    "P//6d6y+mWnU5w+e/PLPrN5Z6Ywv7j/69q/9ArVZoLPRalsqZaZTkz1DQonaaKGHhAKhTG2wCAUKtd5ssUqEarPD63ar"
    "ZXpHCMbcqDZ7E4V83mKwuGP5xjhtsboj+fFpzke9ozDjCjVMqd3h8nzE6ecK+AKxTK0xmCx2B7g/fCEcS1VqncFkto3i"
    "0hGjba3R6vQmi1gglMjlClhLepOJMpvFfD6Amc5gtFgtNqvdLhHAKtTpQRfRLqfT5VKIwTYGr8Pp8/u8Pp9PLZOCtWBx"
    "EniLhMJGNVzIQvtCgG2wDBKURq3RW2l/OJUGuyuTtRp0WpPFBTOdK5VLpZLdZNCZbE5vJJkF+73RcFhMelicvkgiW6q3"
    "JiZddrPJbHf5AOFKoH6nPA6bBY/D0N6YnJrj9HzE6R0Y5YtFYolEpoCLG02UxWoDqXGC5vWBuPX2gbwI4SOCxwbJ0Ovh"
    "J2bmN66P0GFEX4UPZj24JDKFWqPRG4wm+AG2gzj2E3cEBhXaJVKFWq3R4Q+YLoi2H4NT2Xa5Sq3Wdn8A7QNDI6NjeG3S"
    "DjcpUyiVMPZ6A9MBKHvoHP5eLMYHkMmhUaPTasldmi02Pp/HJ/3CB1rB6SFtBiN+oAsxrBt4MKkcJlEB06jSkDNNZDLh"
    "I4LJF8D04xSryJxDo9kM14YP3J9YCA/Oh3alhtw1WB3w1/DHCo3wkXTPB09PBwsIxtYGf0/T+C8N4yMRQbMAR14HXeMj"
    "wV87XTD4uFpcLpkERx7a1dA5DojD7XbDuvYwf7wKGTy4CB4blitlhUlz+3x+v88Pa8sLS8ynkkslEjF0r4XhsEGzNxAI"
    "BkPwrz8YAOhUK2RSKYOFlMXudIOrGQpHI2H4JxSKhEM6NZhDMhhUWMJWB9hToWg0lojFozH4BtfQqFOrVQqYMSP4c2Ay"
    "gaMKKxchLAGrNxE36TVqNYwNiArbDgYZWBjpdCqdSmUovUYD7SA9sFzc/iB40ul0LlfI5rK5DCx4i1Gv08KaM5ptdqfX"
    "j65qJlcoFEv5Yh7EuWA1GfQ67N5soV1gQgC0ZXMFALIKEY+ijTIa9FotMzhufwAMqwycDbqqVq1WKzUQD/iBDgfH7vR4"
    "g5FoMpOFs2soTPVGjbaQHxhNsJyhf7g/0BV5OLsBemG8Oe6wWsBhhJmDiYOx90dAl2SLJTi71ZqYmBx32qxmijIaYSnS"
    "2D9YSalcvlyFsyfBI55y2e0WM1zCbLHj/YNNFE9nCqVqA87udKam3TRttcI9mK3Y7vdHIolUFtza+jj609Oz4I7abHAP"
    "cPuAXnB/UdJeaaA3Pj0363PBFWw2s9lud7m8PvAM4xkYgFptfBzs2tmFnhGBSAGDL+SrwN230jqFyR3NpOJmvckZytSa"
    "PUKdeYSv0AtUJpNI73YqqGhIb8tkTNZUzUrHm4CfXAY/TQQ/B0fGQFYFYolSBYNusYnew0cQJ4tMJJTg9exut8sJfxD/"
    "1CaCf7EwrDmzTqsz2JyBSAamMZNLW406rcHs8ATiMCvVepU2Gw0Gs93tjyRzpUZrkjMokqnNVvojeA4Z6PNeAAsprEau"
    "UCKRw6liEUCWwWAQC+Rg05vNEoECruawK8RKqzPgcaslKrsHfG6jUucOZeIRk0rvDmezSavW5IrlSjm7wewMF8olh8ns"
    "DmeqDZfF7Irk6i2PzeIMpauTBD8HuYifBJsQP03v8NOLwaYBtEUQvwBnEB8BvC7wb5DFN6EA8Q/6UCpVACWGLgxzuVwe"
    "wTcJi28awDf4dCEUzwN8QPySv4df0ILoZbEgPgkQn6BTrZ7p1Wqj7QSf4B5lEpGIxRcTiy8exB+YIMAghUyC+KJQaj/E"
    "l6Df5/H6AkEWP9Q66Jlm8SMGVivos3AoeIEPpvfwIZNOJFPJeCyeSJlhflG+DWaQD3AJIolMJpvP5Qug63LZdMpC5FuD"
    "AgbLC+UjkcoXCiUQ4RLAQNkK8q3TwZOBtnA4Pf5ABDwnUI3lWrVWr1fLNjMCgA4F3Gp3YgdRRsBq9WazOT7ByLcBHx4k"
    "EG4fQ3FoDdZAgCcnJxxWK4ov9E9ZAT693mAQJDRdKFZBgibb05yeQa4I8FVtxOmkHT09Q1wynjpmhj/ijIA9AZoTzAeA"
    "dyunbxR0Jfi2amY2egdQN4LiJPrBSA2OwGKACQeJImqSC+LE2Bs6sir4PPitFOdDr9fDVIthUaF8Yffwj4HImwrHG2AH"
    "1I0YbBcwk1EUcUVQYpBNOc4lrAEAFiuxT7Rk7hwOQApGPkGg3F6YfdqhkKC9AtjmC/g8LrdTKRXLVEabwx0IYaDKq5bB"
    "5UwAnaFIKBDwe3UKmVJDAdJG0dANBo0I7hYA5mQmEY9GgiaNEuwZcowrIGbSqvAY7JssRp7iFj34/DaPP5rJF3KgJKwG"
    "eBTa5QN7uVAq5NI2mG3K7oDu8wDwxYIdpt9scwbDSVgM1VKRNhn1FqvLH0plS7VareqgTAYzXC+czIB936g5YT2YbW5P"
    "BPCkBgjusljQPvJGYrlCHY7dMN9muF44Du57c3LSA9hpcTgD4GMUqzDhXsBri9MZDKZS5fLExHQPZ2AMRBvmVwuzZ7Ex"
    "443QZ6XB/nO8Z8+lk8lYwkYZAKXsrkA0XUB/o0dstHHANB8QqAxjYrVOINcZ+RqLWaCl7RKDzyUzhQJqSzKqtabSBjpd"
    "MNqSVcqarFvssabNkRi/DH8uw5fL8OMyfLhM/i+T78vk9zL5ZPEf/QAFTACrBzijApEUpoHVB4NoRYGQsHqBL5TKlCBC"
    "rH4QCUHCzJSJ1RPwDVa61cLqC5lQYaa9TprVG0qxyuYO+T2s/tDJNA5/IhK80CNKPXwnY6w+sWiMnmge9FlXr9h0lCOa"
    "LxdZ/UIbLa5QtlZj9YyTMrsj2VqL1Tduq9kVztYnWb3jtVucwVR5gjNqy4waE3VbYuMwUz/8gcMZFBp8qRqnf1igcUQK"
    "g8NSHR3JVoQCnTNeaU0bNKC0l7eu+hyRyvLhyXkqkm1tnbz+vlaoTF89//7P4F9zBoaFCj0diIHHQPiKvkGeREU5/dF0"
    "qYnxnIFhvkRlor3gflbwcIQrlKop2gNrujQAhyKJSgc/B1MsXxoeHOaCA0TZfeARF2pNIWgzlc7mDibzlRo4IAqJRKqj"
    "wFEtNibbM/PLerCyKXswWWxNL65cWd+mKRPl9MHh/PrO7u7+zYCTpv2RfGN6fffw6Pad+zG/1xNJViYXdw7vPnz89NNM"
    "NBSI5Wvtld2jh89fvf2mlE5EU4XGzJXd249fffXDT41SLp1Hgmj/ztO3P/z0506zUio1p5a3b97/9Juf/vw3hh8CnT00"
    "DEir0OrxucLI/5QwfDnD8j8YtYI1pNIYrA6PD606jIY1J7vtMCqDoyQAAY/u9BACCHrothMGaGiURwgiCsCUEEDkEj1M"
    "+BSah7l8ASGIrLTL22WQKg3m4gNI0nD5DEEEZr2LCa7BHUDfcG30mrg8oUgKcgla2+lBvYd3UGPiq0PIPoHUkwAr7cL7"
    "Q2UMHTDxkRGuSCJBZxB0vpPIXAzNSlC6Q4PQ+fAoDywZgArwcmk4ORKHi4NMV+othj/i8gExwAumwKjuPlsebg6MXiY+"
    "yxNiZIZoGT8YtJl8sQjea701OS3k83h8uDXoHBADHIIInFusVGpNMPbAohUTR1EkBVGG5/IGwxijrQCQtianpqbnlxRS"
    "0JbgboE7A52TAA7Y0pNT7ekZWF3Ly0x8V6kBfQidxzO5Un28PT03M78wv4wMkl6D/BGOmh06T+aK1RY0Ly6tLF9ZW9/e"
    "3gb41mrJqMECj5MA0OzC8trm+tbmzrWrezdoMBdMGB7ywILPFOutzvzK+ubOzu7V3f39w5uHHgeYXmYctWAik6+Ot2dX"
    "Nrav7e9fv3Hz8PatO2cBj9NB22hQYBGQnkZ7emF9e/fg8M7Rndv37pzePwv7PG5AXw8MaqYI8jy3vHnt4PD47v2Th2eP"
    "zh89j4X8Pi/SU3EQsPrk3OLazj40nz588vjp0+efPk9GQ2C6+dANKFaaUzNLmzv7d+6enj969vLTz16//jKTiILaDkRB"
    "dou18Tbc/O71o/sPHz1/8erN27fffJUn9BFYYdl8udmaXgAouXHn5MmzF68//+rn3//i1yVQ4qDo46lcAcR7Zv7K5u7N"
    "2w8fv3z1+Vff/PDjTz9WC/lMOpXA0+utqZllvL17Z08/fQPNv/r9f/pLo1zKo17II0M0BZe/tn/7zqOnn739+Q+/+uk/"
    "/PmvEzVQ8oV8FkSh1ZleXtm+enjr9Pz567ff//j7//Dn//K3TrNZrZRLhRIo76n55fXtvZt37j/69PU3v/jpP0Hzf5uZ"
    "nGw0arVypdWanl5a3tq+cXh29vz5l1/9+se//PVv/+3/5fQOCHTuWInLVVn8mXzTZvJmp7b39xPhRHPl+LOvOVxbopdr"
    "Cg+ovAmBJdvU+adW3Jnt41h+/7NSc/9rDggw4KdcT/sRP9sYq8QQNdhIHsTLgf53+JgER+19PKyCS0eB/2N1RjKVzsLa"
    "8trWht9B075Ivj69fu3w5ObZ3VQk4AunqxNzW0cPHr/44nUhBYOdq7YXtq6fPnv7ix/h6kLKnyr0cPp5OgeJB/K1dCDO"
    "6R8R6mhfdGBQpLKCdTM8ItE5I+kc+H22SL5alUt07kx9oq1XUcHK9NwCbXImO+tbW367P79w7eh6zBOprB0+OM2EktXl"
    "k8fPSonsxNrNF28buXx76+yLX7Qrpc7G3dc/MvFZFj9JgBYAogtu4+0ZFv8YfBQjPn6Afwy+AcAhiAgZ/GMBlODfO3zj"
    "d/ENpAU8EYZigvHtZ/BLjGawztjFL8ABBKhSpYs/IoI/lgv8wQ/I8kTnH+BPGdra7Xanw8SH/y2+zM1MT80url75AB9g"
    "BVQYfFhbXlrb3Nrc2HCCGU6ZzDaA9GgqW8YQ8CoAwPbV/f1rV/dv3mb4IxpREySwTuT/2v7h7ZNbN++c3bt7Ox5Gs9sT"
    "AOVaKNc7MwtXtndv3bl7/+z86ccPQYhTMbTDfSHMaajWJ2bm1rZ2j24/ePT4xYuXX7x5/TKbiEfCYXBiEuAENcen51e2"
    "dm4enz1+8dnrL7/8+vvfIH8UBwlHAa4igQQCfv349NGzL95++4sff/xtOZdLpRLJWDybLZdbGKBe3wMJ/fjJ51/88le/"
    "/+nPZP3zhHJY30Qhof3Qz+VLDTY3CZ2Q41GeWGdxBPAiyBfhsdZMox5JIb0wAOpDS9Ewp3DcS8L1Yo3Jhno4gccjPKFU"
    "Z6Y9vmA0Cb8eQrrPaAMbHVbRQN/gCEyuzuryRcKxeHxoYHhUDHNNe+GRQYcND45wJRoifql0JpflwTqSG+HiYCXkCoUy"
    "kUdwEGD0wZ2olsUCoUhtob2xbLFeb9ZacjHYKzSYdjD4E+PtcQ0YzUa3P15qtmdmpjuzxH7xBpOV8emFufmFOSLP/kim"
    "ObVwZW1leY3YM5FksbO4vr21tbXusVltnkSmOru6vbu7c3XP77DT/lS+sbBx7dbRzev7IbfTFcwUW8vb+3duHx/fjoHP"
    "FclXJteuHd59cHZ6JwloHs+Xp9a2b99/9PjRxxmY/mS+Ord89QQm9dmTPJjiAGMzS/u3zl989sXnpWQims1PTK/t33z6"
    "4vXbL6rgi+dK7anNa3c+fvnlt79sgI2ar7Znt66ePfziy1/8arxUzBWa7cXN/XuP3nz94++RPypNdFY3bt599vr7H39C"
    "/qjS6VzZuH375cvf/PbPXXtRrKIcaPFVYXx5Cg2YzjCg+Xx1wmmhzC5/qjy+uAHr/erNbDwcBDEZn9+6efbi9Zff9/Cc"
    "Wc6oJc7hUuFenjnYp3DFBjX+DM+cKonp8rjKOz5PRRa3HKmNm778tbNI/uqLZH7/db569cvqxM3vL8Ofy/DlMvy4DB8u"
    "k//L5Psy+b1MPt/Df77BHUuzeqCnt5+npUPxd/pgiK+xBWKsXgChkxidoQirH4aGxRo6mEixeoLHlZv9cE1WX4iFajpW"
    "rNdYvaFRGP2l9kyH1R+U1hppggpj9YjH6snMbu9eZfVJyBksLu/fPmb1StIfL6/dfvSI1S/5aKa5dOvFF6yeqaZz7c07"
    "L79l9c14sdDevPfmR1bvzDQqnY3bL3/by1eZ+BqzTWWOxU22eBP8QpFCb7YNCYUCiVJPCYVoMlNmkUBpAL/eqZBoLJ5w"
    "JKRXGh3hdCZj1oN4Zqp1G2V2hjL1Sc5HvUNiEXjNyBXake/oHxWgAarU4OKw9/bDOhOQoAvauxaw6oVikRDpRQ3+BeCH"
    "GD1rbAWf2ySCc+VgWWsxomW2YvwFbGE9YZ9o2uGQwbkYTAKl6HF7PB6lVCJBHwFj38FgIKBTymFRWx3eUDQej0aiRg1m"
    "O9nd/mgynU4lU2adRmOgHJ5gPJ0rgMRZjTqNAfQcHBfKlUrFTuIPtCcYTYF92Gg6rJTBBC5MAIS10hifcNktFDnGdtCH"
    "nJ6PenrBVxEjQSSVMYEmlv1xutwkmw7khfBDDEFEOBIkSPA3H0F7//AoV4ABUCRakEt4F36gES8GRkbHoJkliFQkQmpk"
    "4mfo7AyPASiT8wlBpGR4GOY2QM5HuvENliDCaLOGia6ZzWAowIzA32MYA5sJk6PRkB7gB13+SMTEV0mAleleT0gik1jI"
    "9Cp/RxCRa5PJhI+YxFWYGJwST2XILZOJgg/cH3NfIjETXGEIpG54xWKFD8MfwRpRXhBIOLgYnoWPnWb4IQAqpUrLBGbI"
    "yNPkj8NBS+ECQqYdHwh6JRND6CP445ZJyHOjM4eEGAZwXMgbwdqC/3rcTHxXjLOC8R0M8Hp9/gDDTsL/KQl/JAFnTwt3"
    "ZoMpx2ZcirAYgwE/E//B8LIOOQwnuB6BUDgSDYOVEQ6Fwjq1UiHHqLVOjwFUJJAi4GvG4tFoNAI4ZtCqVUoQCC1heNCQ"
    "i6AnivxRPBGPJ2D5qlXMqsP4jw+AOp5MpbNIHyFFSum1GjVMKDxcl+CJYTJjLp/JZbKZdBbjTxqVhkQ8wW0KoJ+MzYUi"
    "sfmyGF/WwqQhAQT+JJgUsSRJHCmVi8VioUTiU1oSQLUiAQMOZzINZ5dLIEzlSslmNhn1+ov4Fdw+KJJMsVSqIoVUrYE4"
    "wVoh1B5DAIUZAqhSqSOFVKctFpMRekBikBBAYYxPg0apocfbYuLPJgMG322k/3AkAX4DtDca462JCSdyO+Bx4tSS8DR4"
    "duhPl5GAmpxoI78EFifhr5Agwvh3Ch6gUm0iw9Qm/JLZbDJZrTTtdvv9pP9sqVSrT4BGm+4ZEQhlWqNZyFfqTFazTS3T"
    "2/3xRJTSGx3BVLnWI1RTI3yZXqDUG4U6u0Nm8ge11njKaE6UzbZoDfBz+H387B8aFYhQ0HFJAF6KQHhYfESZ+QAPwRVW"
    "w/JSg7GHDnEwGPITvDMxeJdLZpKIb6Dj4TiN4YmSnYLBpGxIeJMAK6dfJFEbrfaPhgQCGQB/76hQIFXpjMMCkRAwnIn/"
    "gbSLBHKVzoTXB21hp20yocII4+FSgiXj8vt9OrnG6o9GQ0alzh5KpuNmjcERSefTVp2JDuaKBbuBcgaTpaqDohyhTKXu"
    "slC0P1lqEvwcHOYC/rzDT9P7+MniH4uPqBwYdgeRoH9waGgUEUTI4B8gEYE3XZcAHxoZucA3EcIYg4/wA6YPJr4reh+/"
    "ui3Mh+GHcDq6wMbwUlaCT/8Wf6h3+ON0AvzQTHz43+CLz+/1YPjZB/ggQ3xQazDZmEZ8CAI+hAE/QhiJ0KuVSgXS03oD"
    "EjRMsnI8EYsl4tEwAMU7+Td9IP85kH5kEBh+WM3Krz8YjSeQOkQBz8K31YQ/QH6ZsgA++PyMfKEAgwyWCjYQLj0SxMjg"
    "ooAhAwyOC6GAa/WmHWQHCSQiwHaXy4deCiw9EKA6MkgovyYUcJPJYiESFIhEkslcrlRuoARyevqHUCnB6DD6rgcZHqR3"
    "GILoI87QCMysSKZECKMsPb0gIORYTWajd2CU2BckgQB+MTjCFwphJWBEHnnE4VFYNdChVMFkRXDHBMgXEeMVXA+dGHUP"
    "zDwy9HoDrnOQN6QAYP0A8DD2iIpJboHlYBKDMpIzfLoNgMMC8ihSIDhb7YAUNosUrqVg2HokjGhir0AzDXoDXBVaARdX"
    "Gkj8y4+EkVIqlqiMFPq7GHdyq2USqcpktqPFHQ76/ToF2DOU1YHzGgXT1wCTDZa1C3Aa+aKIEcBdZ7G70YRPJ+MRkxYW"
    "mpV2g2uYhflPEnvH5vBEkJbPppMWQHMwvn3hWLZQKORyTL4M7Q/GANRLhZwNlgNldngDCbCHAL8xfwZMPbCXkpgBVgb/"
    "TE9ZnK4Q2D+YUAPyDE/jcIfCmWwFjp1mMzyNA+0nOG62kD+i7LTXH0vmSvVmC/kjiqZ9vni8UGhivHeAsRcVOMSURQxz"
    "J1cR688G9p9dr1QotAar0xvCrIpwzGbSaw0kgSeZLcEFe8R6G4evNA0ALo0KFVqBXGsQqAyUQGu1ivROp9To9SmoUERt"
    "iSV1tkTWYImVTOZ4hbKGaxZ7rH4Z/lyGL5fhx2X4cJn8Xybfl8nvZfLJ4n/PIK5bk5nVAz34DULJ6oNBsDAlMBOsXuAK"
    "QIZAhC70g5Ck2BhZPSHmy2FdWcysvpAKFbAsCU9E9IaCZJ36LvSHWqIye0JhP6tHDAqdLRiPR1h9YlLp6XAqk2T1ikVr"
    "pMPZQo7VLzY95QikyxVWz9AmyhlKleusvnGaKdDHlSard9xWivbFC03OkDE2pPIVjb7p7Vhx+zWH0y9Qe6IFTt8gX2H3"
    "p/rB3zP541kBX2UPFCpNtcIUyHaWVzx2f6Gze/046o9Xlq8/elVIZZsrx69+QH6ob5gn1lB0MJ4tEb6iDyBLoTO70ZFn"
    "+CEuLFOT0xdO5Jj4JxfHnHYHYhkM/HHBW9JSdnBhkplhsN+FCg1IgC+aShVKPDDIJSDBLn8kXSjVGmJYXXJoDcYz5fr4"
    "5JQGrEmt1RVMFWvtmYX5ZQoWB8aais3O0vr6lW0a7DG7L5KpdeY3ru3u3wy6nbQ3mi63lzYObt0+uR8P+tyhVKE+s37t"
    "1umjpy+ysTC4OqXxhfXd249evP66lEnEkoXa5PyV/ZOnr7/6oVHKZTKlBiGIXnz9w+9YfggecpQnEis04JthCVGcZOU0"
    "xhn+hxQQwSjAUlKDXgM9GGYYomq3vbevb2h4FAkesGbMTrcn2OWY3rUPEoJIrgC724GGJ8N7svVFAwOEAJJgu4nGxAYm"
    "ANo9eWBgcIQhiGBsjXawDFGwwDDs3hwmyI5iu0wBeseGksWwXH19vb0YHcFGJIjUYPt1U/DDmIPf10c6J9FXAAUQerDU"
    "4PmgNQESmx3oxxkmCbZSJpsQIyEBUMtJVKvl4aGhweERUmAEUgZIR3Llo7EUtoLRPTo8jCYNOtgqbdfmD4BBkIbWYrnW"
    "ZOK3pAAJ7wxN8jBG8jDlCw1qkYDPA4cK9B8YFHYavBEYeOgYzHFAg8kphj/CAiSDkRBIIRgVgJJ6izBIUwx/ROLSFtrj"
    "RZ6kgCnA7fbkNNYgacCdkctlMCxWuwu0SioNpvhkuzMzszA3v7y8pAV/Bz6gQG2w3sEIzcJtdaam55eXVtZW1reY+BBJ"
    "IAabNZ4plpuTnYWl5fW19Y0r29tb6E8AniFDBOKTKkDn07Or61e2tnewQukGbUVrnxQoBSKpTBE6n51f39i8tr97Y//G"
    "zUPCH9lJgVIMxKkBna+u7+4fHF2/dXh8fHwv6HW74BdYoBRPw8XbU0vrG/sHN26d3D45Ob1/j/BLTgfYQbFEplRBjuXK"
    "5sGNw9v3Hjx4eH7+LA5K2+eFJ4um0L5uz8yvb107unX79OzRk6dPXzxLgVYP+H3oJoH+arVnlte296+f3Dt79Pj5y1cv"
    "f4b5z+EQSQME8R6fXFha39m9RQJcn7z+2dc/y6eSsWg0HAYnpIgE09zKxvaNw5MHT55/8vrzr779ZSmbSSbiMTy9WGtO"
    "zsyvXdndPz55+PQlNH/9w6+qhTzGQUj+dKM5hQzRtRvHp+dPX/0Mmn/5u0a5lAOJTmUQXCan5ghDdHz//MXLr7+F5t+P"
    "V6tFcA0xut1sTk0tLW1t3Ti8d+/Zs5/97Je/+t3v/wjSw1MA4g6NSPW2SLJk0FijpYWtjVggWp3ff/wpZ8gQ44xoAn1S"
    "a5Snj1YVttK8I7KwH0puPc6UNj7F+DjipxrxM1Oqc97hpcMLeDnQPzDEA81jtDph5SYzXTy0EDys1esf4N/88qLfSWOw"
    "ujixsL53eO3mQSLo8wQTxUZnde/2yYOnH2cTkRDWbU6v7JAAK0bnNf5EtofTP6pwBhPgfXDltC8CIM6V2TyhvgGeROsO"
    "RoaHJRprJJHiceVGV6pYFAvUliAIghoPJzrTlNbqLy6srtAmZ6S2vrcTBO3U3rt9M+6NFmYOT84y4URt/tqDF6VEsr58"
    "8+nrei5TXzz4+Es2PgsPPYIBWjXip59IIfK4rYv6SoJ/iF86Bv9QrWcu8K0bwCX4ZzCBseF9h3+9LL6NYViO4B/tYFMj"
    "B/r7CT7xRCTV+D18ShD8usAn6b/BJxJC7uKPiMEfyzv8Qf66Xm/I38cP93v4MdFqTnRmFv4hfkzPLy0vLS58iA+xTLHU"
    "xYetzfW1jZ09v5vIt9MNN4UB5InOwgqWGB3uXTu4eeNgD+UbfvCefC+ubeyBfN85PTm+c/owQeTXg4m00AzwsLgKzbfv"
    "njzAIqOPzzH+HAygmQWjXa1NTM0jfNw6efj4408++fTzL7OJBMnriWCFYQkEdHZlfWf/5t2zpy9evf7yy68K6XQ8HsUC"
    "pGQ+X6u12wuLm1sH1+/de/L0zdtvf/5rhh/lgc3vD6JGxPnuH+JKlQa3Fwki5nhUotA5YRWS496+wVGxXOvAEEC8Ky9g"
    "QNAOTHrApQT2hViusWPFZxSj+0NwLNPY7B5fKIZrAZSRQm2E8fQHw6ideEIMqbq9wXAkMgDrTIR0ntUXiEZjyWGYfZhb"
    "GP4IKrTkCKwjqVILHgjanZk8yOOYHGwZlx9mLlfMC3l8gUpvhrnKY/5ZDewVodpg8QZjMLq1Zk0OvpiOokOxTL05OdFq"
    "q2H2wbqJgcS2QS20taAsTDZ3PF3qTC3Ozy6gPWN1+jPF5sLi6urKos1oMNCecKEyubK2sb6+Cf6JEZyDYq2zvrG3u7Pl"
    "h8n2R1KNyYVrewf7+wdBmP1ANN1sL8Gs3rp5PQTrBeyyVmd5/8bdk7v34uCYR1OF9sz6IUzq2b1UKOCLJ8sT01t7dx48"
    "fvokA6Z5IlVrzW9eO33w8YuneXDDE3DvS+sHJ+efvHqD/FEyX59YXrt5/PST128rmXQiVap3ljZu3Hn26Zff1nO5VKZa"
    "n1ncOTj9+PMvf97CerJGY2Fhb+/h+Zdf/bo7nwK5DsziSDL3of2Xr3btuRix5zbXdlKRoC+czNWmVndvPfz4k897hqkU"
    "Z0gX4Qxrg70jGl+fkAoPKpzJUY0/JzDEanJrcUrnbK5Svs6uK7p0y59afxhJbX6czK99kqvufH4Z/lyGL5fhx2X4cJn8"
    "Xybfl8nvZfL5Hv5zle5wgtUDYNWPyh3+yDt9MMiV273hC73QzxWpnf4gqx8GBkUKoy8aY/XEyIhUa4+mM6y+EPJVZn++"
    "XGL1hlyio2P1yRarP7QKkzvdWZxl9YjNQIcrKxvrrD7x0/7U5LWDfVavhJzBTGf/7l1Wv6QC8fL03oOnrJ7JRxP1pYPz"
    "V6y+qaRT9aUbz75k9U6rmG0s7J1/xeHLjXylwSI3BCJGS6TaMyAUyXQmy8CYUCBWao1CIfi/OoyLKPTg19My8ONoX9Cv"
    "Az/Nl0wmTeCXBZPFsgWsbn+y3OB81DvAw1JVtY6EWD/q6R/mET5IiUEUa2//MHIbQjFYnOj1DwyPCdEExZCoGkxvHg/N"
    "bKmUhMD1RgO601L0wNHjNWEeIp+PXJMBNAIyAlIh8VcNlMVGakQUEvBQNQbKjsUHfq9XDQoI0MyClCasg5BOKZdhZj8o"
    "0BjYTXETGKhak5WpzsykMxa9Vg3NTn8kkc0XCgWrSY/Fry5/GBRXuVK1m40Ymcf4RLpQqTccGBAnx9BebbQ4PR99BA7D"
    "KO9dgEGr62aZY4QB3SWk6HldgojEN9kUU4vV9hG09w8Oc3mERyGVOAqlhqWQSDsHHUimwAgJIqSYGJYFf4JkLlYLC1iC"
    "CAb6/RIiEGQsPxIw7V2C6ILFMZkIf8QnBUZMO7lFLDFiKCQUZr7gosAIGjHZGlPwmToiHnwEbIGRFFphIlVarZbQR1h3"
    "IHxXYEQCKEg+4fMbTeT+GX6IFBhdEERYYkRRTAHSe+1KeKwu8UVCw6QACf2ZbgES80zYSgYf6SObTUISfwXEGetyYlYM"
    "5TEMEu1g+COmXWcgMR8buIOwtpgaJIY/IuFGDQnwwhonJUjIToJfiP4STD2pf0KSwm53utxen89PGCSvVykjP4Ax1+qQ"
    "I7FjjjCsVEIfgUJWgz0rlQDMqrDGx2J3YuAwFGLoI8AxrQrwUgZ3xxhjDqRIghHQ1LFYJBqJRAm/JJcRBogQTBhfglak"
    "j2JgiZD4kpKEPyl0JsFTjZAShGQatHsiaUL+SEUKlEiFEAagYiQAhSVKmRSl1/2r9nAUS5SyuXwul8vmSPxZo2biT+hm"
    "ByLgOGWz+XyhWMgXchfxK3J5UqETSyRzDMNUxvoFtoDJZEUCCAmsboCrXKmw9QtMfNrmcHQJIDCES2VkmBp2i5nEv96v"
    "MIL7yxW6DBOJTxvZ/GmMj4VJfCyP8e1Go8XwS0bCX9kwiItGFjwAFjhgAJvwSxjhNpttSEB5g8EoOF+5XJnEtycwjobl"
    "2UKBXIVlBAqJ2uwKRUMmnYH2J4rlHqHCNCSQ6ATgcAtUZlqidfnVplBCT0WLlCVU5vT0DrL4iQRR38AI7328FIH0SEkB"
    "EUwwfMC+4ksZsoiUsXyIfwGvUaNSYMAXg0vpeDJmMWihZ7vTG05mc4ViHvPv9UhwB6MkwMrpE4kVRoutZwCeA/rpHQE9"
    "oNIawEhEq1HHEwA2g1xh3E+DfC8frmaxW6VCBZYIOxRipcHu9XrUUpXJGQoHdWDZuqPJqEmtt/qS2aRZa7T507msVW+k"
    "/fFCyW402gPJYsVBGW3eWL4G9gjg5yD3Aj/JUjVdRGjRWhkYYgqI+N0CSIVac8EQYSQI0PF9/JO9j3+DF/jWBVjoQKZk"
    "OG78CRPfFf4dfGI+XfyRdAsgmStjcSTF4DOJpxD86WIqsngM+NNYeMbwQ38HP9ykhuBD/KA+wI9AAAydC3xQYwEZCSAz"
    "+IBpqvD1Tr5NH8h3GuQ/mYhF/q58p0C+s7lsCuw1C6F3yZib7XaGoE2msrkc6MJiMZ8l8osFSChANOYLhsIYjcKMZZDQ"
    "qo2iDCB+pB7VanUwAojZQlhjWKtVQXqQ3tWigOIFXD5Sg5dO5wtVjFBzevoGRUwBEZZt2EAbDpH5UDAqELPxkT+QYFEJ"
    "YMxHnIERGG8RFijj/PUOjIzhFGKBMqZV9GNaugCDc8SG0A+Clcsco9rS6THbAQl9jMhrNVot2h9EbymIPtOJCR9LCor0"
    "mOSAXC3mq2h0JN3BKILVQFSNHhafmcJ6Z5QMwo/bLVazBG4Wi00ps52201Y72CtCBckjh8WM8XERHpMCI7fHDfYLzL4S"
    "zH+QUNAWHhfIM5hhcOzCGjMv1kdLVDpSYITqwKdVyGQaPeVwgX0cRfsG1gcmvKCznIxHQ0Y18sMW8LyTqRQYPCaNWgny"
    "jgVHKawvAvsHzCEsCMKC6kzarNNito3XH0FIz6YtAMZGyu72RRMYccxbAXzB1ANfJQ7wUSqAP4apn45ACNrRPjIZsZ7H"
    "GQgmU0U4Rv7IaMGC60QKc9qRPzJabejc4gZZdeSPjDabxxOJZLPVahPmFwAP8I7ky5soxv7D8YYFBwuesedMVmLPRYJh"
    "wncTfIunweOs9IjUVo5AbhwQSHUjgGA8qUIvgBP4KpNFqLbSYo3TK9N5QgqDP64xhdI6cyRvMEWKJnOwTFnDlcvw5zJ8"
    "uQw/LsOHy+T/Mvm+TH4vk88L/O8HPQMzy+qBjwYEfDFYRKw+6OeCPlBq9Kxe4PIlWMOnZfWDWCiXg99gYPUEfmsBJVl9"
    "IREotJT9nd6QIV/k9jhZ/UG+fUEvq0e0Mg3likRDrD4xqnQWbzIVZ/UK+U7lMqx+seiMdl+iUGT1jM1gpAOJQoXVNzTS"
    "IolijdU7TrPR5olkq5xBTXBQ4UhrHLXlYHr5EQf8Qjn0jH6g1OSK9A8IZDpHIM7lyozOSKYkl+qcscrkjNXkiFTmN6/5"
    "XIHM5ObheSoSL81cO39F+KEBZCopF7gIhK/o6x/mS5R6mycYz5B8X1jyYoXWggQRh2wAM4qbJlBIEGG8ZpgrwP177J5A"
    "JIrxUK5IBhBgdQeiqfTo8MioADd6oMF5zeTBz+TxJSoD+DcR9KQbiB8KncUN16602pNTWjAPNeCqxTOl1tT8/DJF+GE3"
    "PElzZmn9yrbLZgFpD6crrZnVnb2Dw5DHSXsCiWJramnnxvHJKfJFgWim0p5f3zs+PX+eiYcDkRRWEF05ODl//qqYScSi"
    "6SISRIenz1+9JfxQd4eSUZ5QhAmmFO0KgNbAtJzKBb/Tj2Eq3AlNpTdgsJ8wRJn8O/4HCSQ+HzNn9BabC0vTYdletHcJ"
    "Ih5ukqSlrF2GKJFi+CGWIOLxSTvgRZch6rb3sQQSX/JeO24Tx7koMOoSRKgojNQFQ0Q6xwR8OHuMh7YZGPZY+Qf4jR30"
    "9fX19pMCoy6BpNIYMNTh8UArmO39/czZXOLKKdErMFsAzcHujSBBReIrmICLu00QVxEUi9NNIixgdmdIfBbvXIwEkk5P"
    "rG5MGkOjHAZ4dITwR2MC9K8xacwGigaTwkDk0ebmcbno0vGEiLcYoMGwIAZLkEEqVRtCfjfBVwlOttlmB4VPNlMqFivl"
    "WrPRYPglQuwhztMk44vki9RaGOEleIYFAmRU3B6wpnH/KTCV2xOTU1MdFZgz6O6Du4NeNG4tmM1Vai1onJ6dmVvUqpRM"
    "gZIBCSR/AAsMSvVWe2oaK5SWF01YDQ14h6OGoaV0toiFMnMLiyvL66vrmxQ6C1pSmQVPFoligVOzM0MiyFe2trdosl8B"
    "uEpk1EBnVZiN2DY2r23vXrt24KJt4FgC1OKuXbF0Fm5tamZpdXMHhOPg+uFBwOMiCcwwY1jfV2i02nML65vIMN08unXr"
    "bsjnwbphrOQEP6hYak1MLSxt7OzfuHF89+Tu6UnY58UN8DATLwaPVm5NTi8ub+4gw3R6//z+Y8Iv+dwYbiObzLVJDdDe"
    "0fHt07Pzj59/nIpGwHMEIyqCe9SVWxNYgrR9cPPu6dmjR88+eZ3B+oZQACcFy91ak7Pz61d2D45O7p8/ev781eeEX4Jf"
    "YDS3WGo2p2aWV7euXb919/zjZ89fvXpbzGQSCfQt4XRmR8fl9e1rh7dO7z//BJq/rOTzuLtFLJaB0xuNTmcR49sHd08e"
    "f/z687df/gIkf1RKuWP9A0K53hnMaNWULzMxvxj2hYqdrZOHnH5tmDOgxrhlaFTuK0r1mQ7lnNhyB+dPYpnFhyx+Ahx2"
    "8ROlcYQn6eJlP+DjqEAsBxPKCdMfQ35IpNCZYa3EMqDx5O/hX7M902HwzoN4N720fnXzQ3w7vZuKBv3BeLY6Mbe2ixVF"
    "nJ5+npwKpTAeKNF7oj29/Vyx1hnEeKBYQ/v7+kdFCqMnODAAVoY1EB8dEessnkRWyJOb3ZFiVS5R06FMa0Kj0Lvjpak5"
    "Smv2Z5pLay4LqI3pnd2QEw9vHMV94UJ7/fhBJhwpzlw9fVxMxIqdzbsvuvz6BX6SbG3M/gsR+qd8UV+JG4WNMvimwwQd"
    "ZIi6/ME7fOO9j29IAKUvwruIb2N8DHwAvpntxLWGVdHPbKCJ3LwIgy7ghFJmTCzzh8OYuPo+PqFNo9MzkhZEhhtusBv/"
    "5YlYfEGXg8GXIn7+PXzBAgX5P8CPZqs9PTPVaRvA2FGrweAmVeqhMNl2daI9Oz+/tDBH6o/eyb/nQv6nUf43r25vXvG7"
    "Gfkl0APyW2fk99r+/s0be/uHx/+O/IIE3j1OhEN+LEAKon8NEjDemV/c2No7vH1y8uDBwycvUjHcwI4QwIlsrlqdaM8t"
    "rm3t3jg6ffD48YsXL0h8OhQOBGKxdJoI4DSzT+O902fPX372Btd/PxYQGSg/mNBZwgdhAZHWADZ7LMGsjVG+RKN3eULR"
    "BOET+kZ5YjVDEDHywsVj2gkqkfBFWFCExzDDbOmuWKWx0R5/mNBJWFCk0ZEyWbQ/RjF8rzc6PcFgAGZ7iC8k25mi6xcb"
    "gGMBFhiZkTCKx5AvEmFBEe0EKE8Q+0Qs1RksLg+sxmwa+SIpFhj5/KlMMVcUwuzLscAoFMkXS9WSCJSJQmWxe8LRQqlB"
    "9ouUqLHAKJWpt8YnmkpQFlq9wxvJ5FoTnfaUBrSDHguO8iWAxrlpIygDyuIDA6YOOmCR5MOYseCo1oR5W1tBvojGgqOJ"
    "zvrG1ta2y2oxO92xdKU9vbmzt7uN/JEXC45mF67tH944RL7IH8wUm/NL+zduH8Gxixy35pf3b5yc3ovD5MOtVtpL6zeP"
    "Tx6cJsEnC8eL5emFzRu3Hzx+lomAfZQsVmfmru7BlD/PwXqIZsA+WtzeP3v44mUxkYjGcsXxzurm4d0nLz4rI19YLLbb"
    "V64cH7948YaZz2GwD3VW0F8Jxv7DDC2rOxhN5gzgDujNrhCYYO35pbnVRMjvCUbTpfH5DSS8n/QMGBKcfk0IMNbfO6Ty"
    "9HH1wT6ROTosdaV5qlBJrEuNK4z5eZ21tmF1t/cAd2/7o0snkeTcg0Ru9cn/Df78e/hyGX5chg+Xyf9l8n2Z/F4mn+/w"
    "v58rNfhiF3oAvsVaV+hCH4B/INE6A6xewKQGcA18rH7oH+DLtBZ/mNUTw8MiDeWMJVh9weNKwVHJ5Fi9IeIrLJ5o6UJ/"
    "KKVaRySHdUWMHjFqKF+6vrDI6hPaREeKnY0tVq/4aW+qsbB/g9UvIZc/01q+ccrqmWQwXJzevP2Y1Te5aLQ4tX32gtU7"
    "5XS82L5y/ILDl+r54LxIte6gngoWe/rAilXrqb5h8PtA6wqEMkyZMgj5GHawWiUiBWZvetSgsJ2hWEwPfpk3ls5TYNV7"
    "Ynnwr3sHRsnWHGq0ZO09PX3DXLLhi5zk3PbC+PGYAI4SA54D0IpcBKkggr8gZfyY0CvDEgu9TswkYypIviX46ZgfJ8Zf"
    "YnjMYrFIMJivILnYNqwoksEJYDtg/i5m6LoVUrFIhqn8ZIn4/RhfABfEDK4zGOjhiF6txECuDQ7B30gkTDo1eL244RLm"
    "MmWzJJ5qtDi8ASxfBn/TpMe9vcD8CJOACPJFOnIcSWTBISPxBSwgEpIdSpC9QaMeGaJuPjSMCBYQCboEERPfZBgiymwh"
    "7f3D2E7ilxi5Ivvb6JhU9Y/Ibt7EVWEIIpGYkFCEIcL8aZJJAq7KOwJISlLkuxEM4oiRAqP32xWkHXtgHB3hO4KILTFS"
    "MqFQ4mxgAr5ITIgSeEgpEyslNUa60e4GTqTAqEsgybt1Qnq9TtcNq4Czgx8SeSMRFB0maxuw/kjIXvMiwKJiSCJSgNSN"
    "z4rE5J5UTOo/YbbMhCXq5rsJoR1uGe5Z2yXfcLFYLZYuf0Ta1V0CiZQgIYME/3b5I0ykQQKJ2f0Ot7ajHZjm+0G75t3W"
    "gGQTO6fD6ZJJxMzWgQQKkaWw2u0OJ7uJnUsukYhEItzLnBBIJnKuE9xd3BzR4/UpZFIxU6CkZIP+zi6DFID161Mp5KAh"
    "Cf2FWermLr8UDIXCwXAQ97eTdwuUugQTrHssUWJqlCIhnZoQTFithwSSFTe48uMONpiOHYvG9BosUMCH0+L2jzZS4BTG"
    "EgWyxV3MqNOqVSSBuUsweXxBwiClcIe7ZBr9NbWa4XOR/cIAMpbopFGYMtk0xbbrSXibCTBjCROGI/PZPIlvaTEciASP"
    "A71sQgARhqlQzFvY+DQhmOyEHoPLp5kaplKF4Ze0mm6FET5dmAlgMzVM/yo+5vBgiVQMIxHgD1eQ/2X4JR3ZTZEQREHM"
    "jMkyAbQqW/+gw/oH3GOOxLfBtsvn4exqowfjaArk1XGM9ZRcosRa7IBRq7d7Y7l8j1BuHBBKtAKZUs+XG+1iJe1VaLwx"
    "rT6YM1KBPPJDXCwgQvyEAQS8HHsfL8mukzLCyhKJQr4cszqY3Yqslg/xz+smeAfOEywDnMZwF98Qv+JI+iGeAb7RSIBj"
    "RRGnly+WqU3Wnj5MptWZegcFfKFUrR8cE6IRrwVLUyyRawCXkZfWG0UC3NkL6yawagrwF9xA6N2lEKOeALyVKk1g7IX1"
    "So3ZGYjHTWqwc8LptFmrt3kj2bxVj/ojV7Qb9RZ3OFNi8HMQtAIJ0L7DTyZCa0djpZ8tICKVhgzF3i0mNJFkuKGxD/FP"
    "cVFCaRpk8U3UFWTmIgwVDT8BbOB1UZXZQZOFPlIhiXnxJP4r+rv41MUfpsBITnrUsyVGpMYR9NW/wReK4AtN8IXgh+g9"
    "/DC9hx8+L+CHitBDYgkj/8g6OFywRskel/Df9+SfEEhgbzHyT6yxaDj0nvya/pX8pjCjx/R35ZOR31wuk7KQ7avUDAFs"
    "xzXGyl+uUID1YzWZ9F0CmBQIEYY3ShjYIghgyYryp0OCF6PfjACSCiIUsHK5huufj/CvIgSRFbQh+CNkPIgWxWx8PoPv"
    "WsTHjzj9yCcIRFKGIMLYvoAUDOEOtnA8MDQmIAXLhDDSDZLqWbJFKqZu6IdHx4RMRZeULBIM8olJQRGWcOi0QqxlwbnG"
    "elOYTOSLZKSAD4eA5K8IEWwxYG+iTBTyRWDq4NSizqHE5O0PGi2zoybZf04gU3Snzk5fHBO2zUljPbRQjgVGMDVu8EXk"
    "IAZyJVocDtARbg+J92LBkcPpA33gUcFkK1W4wxq4qMFAAPkjJRYcgSkdjoYDOoUCBgZ+7vUDxkcjepUS7sZsc4K9HE/G"
    "I8gfabHgKMDs2GYCf0OHBUfBMFadJk1azbvjXC6L/JHeaHN4Q7hjZT6L/BEc28E5xIT2IvJHerC2vP5YAgkkm9GAKfNY"
    "YJ3I5ctlu9GoA7hwQn8Y6Svbcb1YLC5XKJRKlUo1sMNHxph8IWS9jciHv2f/mVUgIGC/UXaHG5SeP2gx6NRISLkDUUJ4"
    "94hUFo5AZugXSnQjQrF6TCLXCeQqIx9gSaCg7CKF3S1ROgIylTuq0vqTGn0wqzOGcgaTv2A0B4uX4c9l+HIZflyGD5fJ"
    "/2XyfZn8Xiaf7+E/2biU1QMf9fP4IplGz+qD3iFc+GodqxeGx0RCcFs1rH4QCtBuxee90BO4vZaJ1RdivlQD6+RCb+A3"
    "LPIL/SEXyfVgdbtZPaKSKo12TyjA6hOdQk05/LEoq1eMKq3FHUolWf1i0pDvHKtnLDq9zRfNFll9YzPorZ5orszqHbtJ"
    "bwEvu8Tpk7v7xKag3JSecgenDjF7XWLwRHDXZ5EW44HDArnRFRweEagodywjEckpX6raMmiN7lRzYdVDu2LVhd2jiD+Y"
    "aa0ePeCQgtdhnkihNbuCMSZe1z/EheEw2r3BGPH/+5EQUugsTm+IxG8GMd4v18I4BHD3H3w1D6bI4/tlBvoB4Eg5pcnm"
    "DkSiw0NDGCzVYA0wiEAa/G2uQKEBje4OgFtWFMFyA3/OQnsCsWyp2sD3zch1FO0JxbOV5uQU5hupsat4ptyamlvC+nG4"
    "EPy4PD67vL7lslvM0BrLVlqzq9t714NeJ42bOZI95A6OTmJBr5tsfDI5t753dPdBOhYKBAhBtLR1/eTBE5YfwqjU8ChP"
    "gHEALcbyAlgBlM52+R2GIBrGB5WqVFiqgjU2ESb+9UE72EEqZCJAHoLvtzMEEZeHWw9odYQhQoKmu/8Sii2cT16zQdot"
    "WNnfbSf8ERvgQMnD3VvBKAfTL3yxfd3AILg+2A6Si6mudoYh4lxssEIIJJ6g244MEnQA88ecjQQRj8AaKAekaZxwf6Cw"
    "+8gGdQODw8PcMbKhuFyh0eDewi5m70eMv2LnXC5m6nWzDa02whAhv8S0D4HH13UEUQ+x7bFEGvkjMHlGSOSmmxZiQ/Ir"
    "glo7ncb6I2geBS0lY0wKsGrdHtyXOZHO5ArIH6FPJxAqMMOXmAxY8xvD1yAVi0UBj7wACYZdqQSgB5Mdd13GaphcHgzq"
    "OuhHrE+CaVUjgWSjXaDvozHCIFUbjTriHX5AnWtNFNnytstFYEH/eFshJRtQYV0EBohc5M4yWRIhmpyaamtAn+FHTQYN"
    "rJEIibPWm+3O1OzM7IJWRTbAg3aTyWZ3YwwznSmVCcM0t7i02I0vIWmHYe1QlEkjJgzS2urqFfAGdJj7aDTZbC4PoYhK"
    "5db41Ozi8sr65tYV5JewQMlidSLBFMcc5npnijBMO1ev7rlouxU3JIBru8kLQIqVZmtmdml1c3tnb+/6fsDjdpAEaBeh"
    "5bKFagNrCAjDdHh0eBz0kn1pAacDeOsk+jW1tLyxvX9w4+j2yXHYR16w5HB7yB5X+XKjhRFmwjAdn5yex0JBH9gNSF9h"
    "2L1UbU3iHlY7e4dHx3fvPThPRiLgWPqwkDyGDBGcPrO4unl1Dzq/9+Dhk3QsFsIAGtnnATcMgkdfWt26ev3w5BSanzD5"
    "1+FAEH2gAjw73v2VK3v7x8fn50+efILVkiKdI9g/wJVqrf6YVKKwBDKNKa/DHa8v7h1z+qVezoDE0cdVuIeklrhIG6jr"
    "rJlFh7+xF4xNHV/gp1zD4ud7eOkLfYCPML1Ih/KkCi3umR2MpVJSMdhrGkA0fyRVrLXqyA+hQolmSq3ppbVFv4u2OXyR"
    "VKHeXtzcOzyIh/xewLNCvbNwZffW3TOwR0eklD8OdzEs1rtCuPuLEPQA7mIg0ti8vX1DPJnB4Rvo50o1Vl9keIinMDoj"
    "Sd6oQGvzpwoivsTgihbqcrHc7M/UOxqF2h4ptRfMOtAXrcUrLostWJze3A063bHa0t6tmM+Xaq0d3k2HAqn64sEZG58l"
    "+DmC+CnXaBA/wfrBgPt7/DjmFTD4hnuPOMju7dF/D/+QAGJf39YliABfsYSoi2+wKv4xfrlhtANBFp9GCT6hV6IzGt/h"
    "T2oE8AUAZpTHl5KSfgMpW3bjcoun4HOBL6ILfHFd4EupUgPpR18NHxtB1UESOpOpXLFaq7ea9br8Q3xwfogPM/P/SL4x"
    "gry2sjhvRn/mH8n3xvZulz9C0t1PiO9qfZLIJ9YoHB7sBr0erC+0fyCfiyCfeyCfxydnccIfgY4MREgNHwler1zZ2b15"
    "6+7d+2f3U9EobnPk9WGUIputVMbHZ2dXV69ePTw8Ozs/f8qsf1jScsrsD8aZfIb+Ya5YajC6vcz8Msd6AxJEzPv2MPyo"
    "1TlgkbDygsdIEDHZDsNgQsCxwxfAs9HeEIk1WhvtDZB0FZxNPAY8JfIFelsmNxhh8H2Eh+TyRXKF0YQvAhzANweKkJS0"
    "2uAZw7AeyLEWjv0wIsODjH1ipJwuGIHECJYBS1VayuL2YH0tbxRceTmYHLQ/kEoXsgIwrUVKHeVwhsJZwBvkiyQqpJei"
    "sUKpXpFh8qCWAn8jlSbvr0FzU4eb6WWyMLbjGtQFIO7hWLE02ZmeRf5IbbS7I/FSuT21MIt8kcHq8iczzdbC4sqqWY/2"
    "jjuQyrbGF5evrNIUZbQ4/ZFcsTO1vrFzFfkjGyBJsTI9u4n7eTkcdkCPVLWxsHht7+Zh0OUkllatubS8d3CL8EfuYDxT"
    "by2v7N+4ewbyDPZRKt+aXFs/PLp7lggGvIFYCsynlY3D4/vnaVgfgUSqUp9Z3D44OTvP4npIpWr1+fnd3bP7TxnZH0S8"
    "01tdPhzfwVGwUVQ6vOtIQv6hPTcT9Hxon/UMyIOAsR5Ov9jJGRTTvaNyV59IFxiUUNFROZ3mqzwlsS7UVBjjU3pbdtnq"
    "rmy7As0DX2TyKJyYOfm/wp9/B18uw4/L8OEy+b9Mvi+T38vk8wP8N7jD7/RAL+gBh/+dPugfBv/Ax+oFfMkMfLtZ/dDX"
    "N8yXG50BVk/gN+jDKKsvRob54E9EU6zeEIyB1gxli6z+kIlk6Gc0L/SIXG0LFyenWX1CaQ2uZHNhhdUrNGXx5zrrO6x+"
    "8Tuc0erCtZusngm5QP8u799l9U0iEEg1Vw7vs3onGw2m6vO79zkCsUYgVxrESrtPY/Cle/rAM1boTBiFEYIcczFYI1fr"
    "sJoISXqxkLydzKWQyvU2TyisU6kpZyiZMWl1Zlc4U4D11D8iFonZACcsrsFRoVDApMQbTBjfGSMcAe7RpdX3Dw7zyMty"
    "wLtEHgQjfyIJcitSZIG0+D4bCbOXO9kfBsNrYlI7wmywhPFREdmOiwRIbbh/h5gUX2B42OHAeKkYHVTMtcb3y0jFuNed"
    "gcJtorvve5BjrRMN7gL42MgXKbVYEUQIo6RJp1apMeDh9mHGW85s0Kq1BtwxJRBJZnA/Hox1wbEX2dwCiW/2YEYg7jBH"
    "AgzI/6gv6n+Y17WiPhUKGX4Ff6HsMkQmirSTF6IKhcxWbRh/eLeHEvJDvZhqxxUQooOksMpYhkhvYOoRQVDZACqT4qpQ"
    "dlPd0RbA5ncEkVDMMkT4A6w0Rj8OG1iCCEuIuhFUPfJHWIjMJOATKoaQXIStgXsYAW2PwRP4S8JziLF3UmOE0RCtFm0B"
    "dIS6BFJ3jzp2jyc9qS8i/BHZoQUDsAolu4OdoVt/hFe/2MFOQeqImEAL2R+KvKBIIBZ39/9XqzXdHV4wyR/3j+Lz2XZS"
    "gdQN7iK7BBPU5Y8IzDEVSBcvNyEMkuSif2ZSyC6ImAGMr0Gy07RERDaQATOLhBB1pGcLwyA5wJCQiQl/RNrVGlL7ZGG2"
    "uHO5wNB3d/kl4bt2Ut9EIkQYIOzyRyIpEkjMLk92O2GQMMfY53+vnakqwddWkTdfkW3u/GoF2eAO6Vc1IyRYouRlGKRw"
    "KKxW4gY3UgyPqskmNXi219uNQEXDyC8p5LjgNFrmLUGYqsQwTPF4LN7ll9BQ1JIXPGH8KsAyTMk4xqdJAnT36sjg+EIY"
    "ocb3KKW6/JIKawmJK4t7yPkwwkVes5RLU3p8wZJKSSoYKPISIWSAugxTrmBm8qfJ1clLhNz4DgYsEcqQELaFqV8itQVM"
    "AYMXzWiyHyq+h4mNnxECyUKc/G4AHZvx/UvIL+k13fh2d4+5cBzfoYI7evTg+09kar2QMAA6owTwElwVr16NCXCpbI9Q"
    "oh8QCtVjEomGL9dQQoXZJVPZQ2qdO6U3erOIn6Pv4SfqnTG2wBLu6gIfJcwrcMQMHhLZhAempCzekYJKt0OtkOK7WjDe"
    "geGQoFGrVpJD8nrKdNJi1GGius0J+JXI5PIczohYqjZaenpH8XUBxp7+MRIH7B/GGLtSMzoGMi1Tw3VJDYtBJBCTcggx"
    "X6TCd2JJBGJ8fZ1TJpJgArRXIZFiol9QLQN94Q1F9UqV0RGIJUwaDdEbZq3W7I6kc1a9lnIEk/kufg6Ocgl+dlP4LyK0"
    "1h5iLwP+XeCbiGBsN0BrQFuFANyY8L0KSQYf8QfdPLn3CCKyiSayyQSC3sMvCYNfEqlU1sUn+Ig+wB+WIeriEyCB+H38"
    "6eLLRXGTmSLtfAGDLyoVEyAm9UfdGgLpv8YHTCzACkbc/PL/b+9Lm9u4jrX/CbFvA2A27DvADVxAQiRF0qJoW5Jjy/L1"
    "EjuJEldFb/whTiVVSVW+3P/79tN9ziwHAIcSpWw3qmKN201imTn99Dn99EJbHY6noECB61+4Q2YEH04j9q3sF/yytu/z"
    "s2Uf9t1s4OFJgFnZ9xnZ9yX3pwvtUzGsJ4F9ot5kk33esH1+uoN4irIv2J+2r49ubz9BA9cdti8meJlhnWuG9eYGBDD5"
    "z3ShDKfXRMRnZyeFBnKChx0sgkAm/EWobCudwUCiuuM2mSCitcPNVx0QRvQdMnnFrzqNJvCaNrE8nA8lHkDIQhmvhv2H"
    "3NEKBhRxc1jcwUHfqvLAIo9Ltuj1PWmO2pJFOdYytic9eHDpBQlvOmTCCHwRNyOkL8z5C/T03VZXvv7u3o7ku/QAJ9tw"
    "IeCLPHQp4uj94Rz1Rl67P+J5bpif52KgEadLEvScoL6I9jODMeJTSDFo07JVMt3Ys9Nes+mj2mBvf3GCiiOSMax8SmfB"
    "EwLtc/BH2A7ND5ZL9DEFf9QdTLYPDh+doW/hpCd4cXh8fo4OZmS32AfSXvz8gmV0IyX56PgCBNKn4I+wfTpePL58SngC"
    "/gjRhiOy/acfP3u2OybsnM7Q7OLqySefkjweDNBhbrm8vv700xd4vtjaaIII5bxeuP+bNj18/57UzpFXM/dnKbc5TTne"
    "MGO7vaLjdC3P79mt9shu9ab11mjXbk/nbnv72O/snjZ784vu4PC6Pzq+GY4Xt+Pp6SdJ+JOEL0n4kYQPSfafZN9J9ptk"
    "n3H8H060H9jKWPBrQ+0PMoUanw+0X6BNPidqaf+AeDXODdpPyBU8kfgLV58nlN/wyG9gvIr2Hw0HLfIPjwI/4sGPnJyG"
    "/qQ5xPlD+5VhuzOeLy+vtX+hdTvlc4nyM7geXdx8ov3NznCwfXT+9Jn2O7vjwWy+vP40nfUO6Py8pDPzlwfLL/+E+Kbd"
    "3T2FH663p0eo/aED3oJgpD3aO72y643R/NHNZ912f+/R7cvvd6e7p3Sw+un0aHH12fc//ZX7c2SFIJrNH13weTorBNF4"
    "d3Gq5osXKqggmh0cp3QAp44xZvMj/u0C8sm8Vn+yd4ByFARonEYbXeUW+ZwaGNBDUd3yrIR2P3UhjA5PH1+BL7IcIYyW"
    "j29uXZtO6Q0hjC5vnn1G5yHfa0uA4fb5l19hnkyrL4TRi5fffo/5wPRGHFB99d3rH+e7s+kE7Rxvnr/87jdvfnq0OJhz"
    "8PXZl9++fvOnv1yc0ipdnF3dfvbV9z/+9Je/Cj8kHebypVKt5roE3GzxtCu8uNb8TpoDDEUcaxpgiMa7uwsUEd1bzwRR"
    "oYISIk/eAXW5y3vpJbyBz2ehhMiHfjqdk286SdIHn62AnQUfy2Da/T6qIukdkvRZblBHWnltclN02oN2d/cIRUZJ+rwq"
    "QBICyWesAkNE7mC5PDt7nKQHf4QCpLJ8L3FTe3uHh6enj1GElKTX8V06rsrnUl1jl48f3yAJOEkP/ggFSPRU4UChxXnh"
    "Es0Tn3322RdJeuGPkDSBAPEM2vPz6+vb2+fPuV9tkl74IzRtBYG0d3z86BG0L16A6fj++18n6WfwX9zhaiL39PIS2lev"
    "vvvu9esff/x9kn7O/QqmosU9vbl5Dobpu9/85s2bn376Y5L+0WJxwAGwoyO5p8+efQmG6fWbN3/601/+8rckPfglJpgW"
    "IJiubm8/+wyThH788aef/vKXv/7170n664sLtGnBfZFX/+KLb7759a9///s//vFvf/v73/83zY05Z8e5vOV3J4dnDb89"
    "W1w//+p4fvj42bdv/pzONY7TeX+etdqHBX/2uN5dPGtPrr+dHT5/c3z21Z/TMr2MCSIC6HM1T4wDpsMZ7IsLIMpVKbE8"
    "0HiIACrwkPHPDfGvZeCdiW+YZwHgBGH0+s3P9P7pfK01A04ggfwY9RgVb3CAD2X5gzmT/V5/jz4SBscf5rNFtz3cPS0V"
    "yuS4Dh/XKtXWZL68oX1gd2dx+azl+cP5+e3Lfrs9Ob5+8e1s2N9d3r56PZ9NDh8//+7N8mB/efPl65/Pjw/Obr/68c86"
    "PhvBT6xF2THRSo7wQ4Jv9bpe61H826gP0E3wCWEjsfPJZB9FREl6A19ayEsd6rW+ij8r+gAf4Bfuwo8N+laCfSfpH2q/"
    "y+NjsS9tnc+eMUdK9vUzipCS9Nfn56cgcPkbSY+5uP1ww4x8rdZqzWbLpTzvXM6yGo3x+Pj4fI2M51WpeN5gcHBwaspq"
    "JVmW7w8G8/nJigxvg6flef0+4Z0p8yqSpzGZ0P0w5Xw2WyxCGg53d+kbm3KpUCiXfR8r+PCQvrEpgy+qtlqTCdY3nQlN"
    "GXyR3e3u7CwWl5eENqYMvsgfDufz8/Pb25cvvzFl8EX0SY+Pr69fvPj221+b8gxn093d5fL29tWr169/b8rgjyb4pM+f"
    "f/fdmzd/NGXwR/v4pOgR9/PPfzPlc6yHs7Pb26+++vHHP//576Z8vVyil8KzZ9988/vf/+1v/2vinYlvJp6Z+JXKt5aM"
    "sbSvBc5mit4esJb2uKfA20prfgPMpf3uS+DucPf2NbCX9r4/K/x9EP48FD8eav8Ptd9V/I/7gRV/YPgF0z+YfsL0F6bf"
    "MP2H6UdMf2L6FdO/mH7G9Df6er1cPH72ze//lrYdnJ+HDp2Ze8PjJ+CH3GZvxFm6XqvH/FCz03fAuvRHU9f20Y9k3vSa"
    "OLcte63OaPf4/GrUQ9eCq6fp1BYKiCTAif4USAC2JOMaPXG2kCBq2ZIGTydg8u4lTJSW3KluD72DULvCwyXo2E1ro64C"
    "NFzxAb5IBWi4SMF16iFhNEL9CbqLCWGE8DX3e/cVYbSL+Q8IrglhhNnA7Sa6fQlhhGID8EVsfDs8ZetiiIRNjogcgJ28"
    "miBAjooiBFgvn9zMEBDvc4BieXF18xTxBRQQ5SsVFWDQDNGQmYKUKiAqWpogcsPfGI0mSfotTqDPlUOCSDNEbWZCkvRs"
    "q6VStVoXgihkiJAE3Rsk6fNi5fLJtF5/xk6nl6RnW8drRwgiYYg6/PmS9Jo/0gSSZpCkBinklzbpXY7PhgRSyCBxgdJ2"
    "kp7ju9zBzsNnUq86ViwQ+kvdrdf8EaMksHCkGSRanPP5QZK+6fuyLuSsBy1HiKVL1fEiSd9uNj0mkNBVq9/XLMch6HwU"
    "KSXpEZ/iAJVGclTRHCKHGV2uLh4n6Ye9Hk5b8uo4a6KGgBmmczTJ+yhJPxnSb+DMJhYl3oIZJnTZublN0gu/1JNXj0wR"
    "ukCE+unTj5P0El9DAcVQ9ZhTFRAfYVD4x5+m8lWeUM/8EAGD7/i9KWHHsNubzk8vb1KOP8w7TrfqI27ZmyJeiVhlu39w"
    "ORgd3wA/UUCk8HOK8dblqgqYtnuDguCjI60lO13ET50IHhL+2YR/XUVw7XI/RBVQBd4JvglhBHxTeDbVeJZOFdCri3Co"
    "iL8bbqXLdp0cQgYNR51GF9NgkFluVR1UsfQ8G+OQekMXY0Lodby63ULDJ9+2ua9d03XaSAhv+14HTXN7TRktO2yT/zhY"
    "Xk56HXR/eDIddMmPXNwo/MSecxU/yf5Ssl+WnYYqIQoQcjAYJukLUXxyFEMk78K2nqTX/JCzHl8mSXrhh2zBB/zfgCGK"
    "4Mcd+qYvDeoC+55Oo/Z9kqSP2KdEipiGWGu/a/Ux+9IzhDbZ3xr9tmk/h4cnJxH7oedfQIM58li9HmEXPc9iUX8fWgOm"
    "vJVOl8u4X0AselVTJk8soXxE1rrdgSnT6QSvBo/Dd8yUwQ85MmyP74gpe1hfLU0YDcemDL7IEd+J+7FtyuCLbOy4hS/b"
    "M2XwRbbEI/lJmDL4IqfdHo22hTAyZfBFXqeDeCp2wI9MGfyR3+1Op/v72Fk/NmXwR02cBw5AIF1+ZMrgjzrD4c7OMQik"
    "J7emPB0Mut3RaHf3GATSzcemvI31gljpycnjx7e3n5p4Z+KbiWcmfqXc5gQYm7bdHnCWnmZbsLY9VBzRTowj6u6fA3ux"
    "9xX8fRj+PBQ/Hmr/D7VfE/9NP2D6A9MvmP7B9BOmvzD9huk/TD9i+hPTr5j+xfQzpr/R1+1hb7J38vg2namPM6XGtN6Y"
    "X4+n11/LeXCwx2Ogve4M572q153mckWUBB1alWp7Mj+5pFPqAI22aXVvnzx58fXebHp4+fzr3wo/hIR3IYgUP1SgNc4E"
    "keKHkKPLBJHih9BrjQkixQ+VKlUhiBQ/VMOELhBEOY4XoN8mSOGD02IBk4RdHoSzM1+cVzAQwPbVkeXRVb1asaoubQBm"
    "3FP2qfBFnQEqdkAYCV9Ef3sgAQfhi8agk5gwkngqBrRKQFX4Ip6/yoSR8EWn6L7NhFHAD4EkySP1jJAZtXFjzMd69CgV"
    "I4AKkvjBpSzj6e7eYhGoY/rGGj33eStiEFDdE05ye/vwMMIP8RD3ojBEPMEPIKb7M6kghvp70U+1PqMJIhQf8+tDP5zO"
    "5vMwOsI5+ChO1n8/BIgG3fE4QFIqV/D5PXQv6A8Ae+l4AKXCiX38+pjxub/P/FBWE0Q1zqNscMeJyRQUUZI+Jw1eOACj"
    "u4l3eHO4Qxvr09O8agDDB07VzQLkMZItEU4pFgoonaJPXqvpaY/S3Hl+AAdRKnKBEn0xuS2yb2Zi+ggBl0q5LAVKFdoW"
    "N6XvAM4Ec648vrri+A8nDTqO+tJS1sh1+zc39WoVEf5qtcrLpj+Usn9V9vz0Kc6YXKCERYGKSxzykROG6U9Pnz1L0nN8"
    "if+hfmGMOt3j4zMpiQYR025Kgxvw9dyTG19bWnJ+goZq5O1a3AqDNhujMfehg1/kkYxffPH114pfaqMsjF59j9770SMe"
    "efris5dffvstmRPBcbfbocOSGul6cfHkCYZzvfyfr3/4AdXWOsC1gxDF8uzyEuOjPn/1FUJc6GaAhBspGzs4woCo648/"
    "QYXU199//7vfYVrqbCoEk5r3Cobpi5f/8933v3n95s3B3h7PUcRq4XGSl1x/9cWXX3/3PQqBHi0Wh1zgpGbVXeGmvfzy"
    "629/eP27N//vT39K0gtu9raz2UIVgbCqVSPve3o1HvR3l08//y6drY7TWWuQKdT6uWp7t+JOl157/rQ3PP18e/fqO+GH"
    "CD8VQaTipSDQOWCq+aGKIogkfor+HBJAFX4IGTJCELUMfBsjnQLFl8uLm0+/+PpXh3Q7psiWu3r62atf/vYPEh8cH2o/"
    "IPHA3rbEAXszif91pxL3G+3lskWnOZgdFvNlr0sepVKqNIY7R2c1q9qeHiyvJL538VTiejefSTzv01cSx/vilxK/+/q3"
    "Erf71R90/WWInxyh7fVHWIrLCP+dVb+wHv8kgCuD0hifeuhFeXAQKsnMeciaxh+sKMG3aID3TnyqokIgjj+YT8/4UgK+"
    "8DjrbpeTM9fgCxKZu90YvoT4QBv6NfhQY3yooupE4QP0wIdHjA9k33fab5Kes02xY+qiIQD3kST7vPnkUx44/Ktfmfa5"
    "MOzzcH9vB3k/IJe5IhUfiqzz1de//OG3v/3DH5bHGKBC9oODECpi2X5eiv28+flnxY8WQRCNZ4dLvX+wqo3GcLx/HJUH"
    "4z2RMeDC8v3+cOdQ9f/icGRvsH0gfJHkP5E8V+1TixY2ybRBUeP2SPa87mC2r+yrxHJ/uid/XSpXa3RMIFkWlcVpH6PJ"
    "3qEp57idkcP1obOdwxOyz0Kx6nI4f3v36LSI5oQ1dAMnbzg/QX5LuVz3+YgxP1w+rpRK5DoabRwpjhZnV7UK71+6E1qb"
    "p8tL5CeQa2jTgYUOJGS0zBc1ugMQRheXT5+ZcouhfjCez8/Onjx98bKFXhHt4WR+cH5+c/vZyx7QvDeeHR1fXn7y7OXX"
    "zB/Rhud4cX396YtX346wFobbeyenT568+PzrH2bItqLN0/LR7e0Xr375ege9Z6Z7B2fnn3zy8qsffjff5nyaxePL58+/"
    "/u63bw54dvXh4vLqxQvISy4+W57fPP3yy1+9/sPPpqy5GU4YGm4fmvu/WpUs0uWADjZhT/X+bKH2Z6lsbcYYm6kM0rnq"
    "IF2o9rMld5K1Wjv5Wm9esocLy52e1Rs7l3774LbdX7wYTh692t69/O7w6Onr++LPXfhyF34k4UOS/T/UfpPsM47/w/3Q"
    "D6RzFb+/o/1BSvm5wC9wo7lu4B84z9sP/YTpL4Qn2j7SfkN4ovky8B/ME51emn4k9Cd8/nih/Qqd48dHl5+81P5l1JNz"
    "ifYzO6Ph3tknL3/Q/uZgm84rL0K/o68py2kh/czxRzut9s5pKl106TzeS6PBOJ3zYNvoxuXyWPRun06vLXSm8h2c0/YO"
    "yL7o6xzSuRTnsJNz4Yccz1MBTuGH7IAgEn6oHhBEmh/SBJHwQ5LRi79Q/FBAEEnqr/QmQ8DA494xunwFeYrgizifE0N7"
    "ZsIXNbkhHcY9CF/E/BETRsIX8QRkDjgovgjUFhNGii/CkZUJI8UXYXo8E0YqPgF6iQMUHF/gHhEV3AVOIOXoAT4dbY3F"
    "3LKSCucGDJAqsRkOWZ/hZtvSgo5buYX6Ldbn0AtBWtDV7eAVENTe4gT7XB4EUT3KEDUkhJGWBNgifCq3SNF6lSgrpkz4"
    "rwgiO6KH6coxqVzhprEhg4SP2AAhkudDULUmn1zpbScopeJmB1a1FgRQ6pLDz9+x2ekwP1TVBFHAEKFTC+ilXpJe3xIp"
    "K9BN7FpBCAbdW2xNu8UjNEwDeTqm47AeGs0RcbGQ/sg2SDdFIGktKpjw95pgUh+JM4S5vGCi6gcUgcQt8KT1zJiLn2bo"
    "f6cKmOQQidOY+ltuRLXrq7IHEEhc4aQZpG0pUkrSq/41qMoLWlxNttV0hYOjI8SfNMEU0avpWejX2ODCMN4GouwNDFIw"
    "vfvkpN1s+iHBxH3iwPGIenF62m0B0fHgmk0e24FX5/zo42MEilV8SxFMqg0Od9hZnCDE1ZfzWMNXRXUgQRABw5AGJKQO"
    "exh4qwkm7oKF8yT34EIQTPRtreck6j15ddZPhlIfIdY2FlKZX/z8AiG0JH0qU3bqbqNj1RAXa3YIjnhcfbvh96b7x0vC"
    "23amVm+UHdtHnLPuDaauP9pvNCfHnc72UvghtgeFnypeqgKmIT8kBJHET5tBAFXxQ1hXTBBJPLWFcArjWxcNXdH5brpN"
    "0smjEQrGMMsIFZPL8yuJD3ZHEhdsqXhgoyNxQB3/85oq7td1UHFMr4c4H7oakb/iQUkc56P3lPje9p7E9fYPJZ53sJA4"
    "3vFyqPyGxO0eXWn8RIAWLZ5UhJaHnCn85BENHKBdg3+Sq5wvhAFcjuAGCIpGMTxKkWFLl0Bq/Op2CxH80gFe1qsiI8CP"
    "VQvwx4/jT78vf6Lwx8QXMmU3AV8UfrD967LKgdQwRvBBEdjtVXxoSv/KiP2OJYKs7DdJ35X+Vb68O/dFI/vkLnYLWFjM"
    "PpGSIVVAgX2OeDwKvQjPVxmNJ9vKvk5Rgnh1ZdjP1LQf1M/RzokJom6P8yXynF/CAfH+MCrjELyVTmM+B1qOEuJ0+5DL"
    "lhBEDfLjtJS4HJblBu03yDXyfsPmoUZdLDTU0tZZbnVwOnGkAx3sqy2ydBVEVz92m64miLo9U+aaX1+cjtqf6HwWxivm"
    "h3x4SvijEc9X5FLDroTlkBmDfBcpiZ2gPx0afCGkx93GPNGjdhQPbhf9dTG1Had5NMQ0ZeaL/HYXhNHe/sFRVEaQroV6"
    "NEyFH++iFFT4JLpvYxVP6gDv6b4ilomOTb2m7IcQ+zwmwOgDz9s9lATNFyePLoYd2R/hbIAZ70PCax7JsX14iFl1Ey7+"
    "HI53dqXfjimnpMGcLbex07fi+7++7O9awX4usj9jwjtleT1gbNqqN3N1m3GWjqMt2vN1bb/Tt73eyCbMdfzhDuHu3G9O"
    "Dput6QLY2+/vnt8Lf+7AlyT8SMKHJPt/qP0m2Wcc/9v90A+U6Hs2u9ofpLMVXNvaL2QxiIh+UfsHurqo/NJ+wvQXwhN1"
    "B4HfYJ5oMI75D/JKph+J+5O9A+1XWp5LfkXzRgeLTgPnkqNT7Wf6rUZvOl880v5m2GnRqez0QvudwP9krE6maPcsm/xx"
    "7/g2xQVEzQkOyIWaN0hj+mfd6+N85zS7syJ90fZwdmjX6s3h3vFjOj50Z8fntxOMDX58+yqtFgwCnCjqkfM0z4S20cdA"
    "zxfH8ByP3HRKNuhMEEFW4VB2WbTsReaAqEXHnE4f8QIOyNgOGjRM8jIO2FXpebvSXqzG4nRn7wB8ESYWMWG0f3jM8VPL"
    "Ef6Izsfgi1BgBJHM6bLN4fM2wqsLMs/bfofHBWOk2PLq5uPno3632+kMUYB8/uTj558jPoGACQag3T7//JXih3RYVyIM"
    "mP7W5pFt+6lUNMKJVGU+2DD6DyaTnVSEAAr0aCeK6s/xeCdUpzXDw/llXA060vc7MqRDGCL2nt3BYHo/fSaje9AxQ0QO"
    "Q+knqXSMQNIMklgn6SMvLVsPpWfvHeqFXpIICk8qEgqpP07SZ4yPhhCtrZuSj8fbWVWAxG9dEQbJkbNeH0xNlv/xR0PT"
    "8rrUY6sgzWy2x/GbbF4IpLrqhy5nWWZqkvSgj4QZw8xIfmludc7VswcHC+aX6KNxCzy+a7xtR1oaOhucML9E37pcwQSD"
    "pjBM2HYzxXSM+JFKMLYAQ/KtttWmYrm8SNIDbWs4zDK9xd+aHeXx8eny7PHjj9BvoiYEE2YUopB0J2jaTRsWHKeE8Hfo"
    "pvZ5Kiw37T6l/cxHH90Kv8TTetFPAE19wU/x0MUnt7fPkvT9Lg/oxoFGDGJXiBjMl/r4+fPPBwznqoUec0Tc/w8NDW4/"
    "efHiCx43Cf6JR1vRA90/PMHIuSdPPv7k+eefv5JprqpFj3z05fLx5UcYJ/T5q1ffJOn3d3h+02RCa40Hwp4sLy4+enL7"
    "7NnnX7z65psfAHbFmj/iPXvd7xPc+P3t+bLbag52T6+ep9NWN52ptNI5q5kt+INiub9bq2+f+v78atRfPo/iZ6un7DnD"
    "w3aAj0OxDUUQ0T5Aoo0VBJOAadslA/8E79wA71oGvnF8Ffi1AH79gvArnSvVWnjfXNFqjFNc7OkNOIZjwR8gduv1+ftZ"
    "7BeA9JM8eQ2/PdyFf2j2pgeVUgUd8Ra1SrXRm8yX5OcgXrY8OhfOz297rdZw5+jq+aiL6OCTX8yG/e2D5e2rkF+P46eE"
    "aGf7a/CP8GsN/mV0ij/rbb3cYvgVwbcofgX0t47w1lX0QOHTXXqGB40v1WCeQYctibagEfxAc1Ac5OTgj3RqWm6lBPwI"
    "4scIp623/zv19PhdbmCFFlYA1Ilqqo9hVmQkrQfap7affmA/i8B+fhGxr016Wf+5fKlWa7T6M/U80cTNom3aZBKVG53x"
    "WO8vCpUKhgaN9HwYDke2BoM1Mk+PQf0G5GCdWShSGYT7D9b3+9JNFXkaJDdXZd68SP932mKOx3j4hQI/Wnpyk4nI/Cg7"
    "3cFsxnxukR8NPZndXVMugrQsO36z1xtPdw4OuD66jPGzfbpdh4cVpCZUPBBI2zv7iwXzR1VCatBNR8ulKTsM9rSx2t4m"
    "kH782GVopycL+ml5eelzdLDTH+3u0kP+6CPmj3zCjvmcHurtrSn3+OkTmBwdXVzdPH/eZzQeTeg48/j66YsXI0bfyWzv"
    "5OTqyce/+MUMzWn627sHy+WT2+evXpny/mxKULp/sLi4+PjZ5998EzxPwjukxZl4Z+KZuT9LpWv0jKwOY2zWkh/GWreX"
    "K7YnhXJvp1QZ7leqk6O6vbME7rZbRze97snHGn/vhT8b8OWh+PBQ+0+y32T7i+J/cxL6AToPVPxR6A9W/ULR8lf8g75m"
    "MCjZbo21v0D+hO13Z9pvmP6jVCgjQeLQ9CP66tTqLXRG0H7Ft53OaPf0I+1fTD/Tb2Pe6/UL09/o6/50vL+4ePZNqmI3"
    "Kq7bsN3+uNEYz+k8iMffSaXL2Eo2i2VOePRpUaBRRpuO5xgXjDhHo0tP0Hfo40+29ztN0Jv7C8Q3s1xAxNlEPfBDKqCD"
    "/qTtLXRX4wIingHQBFSVeSIRyw1pvq2m/9Kxmw9KHKARGVvcICBDJ26Px9WoZmN0yOZ6IgRc2nK25ngCFxhJJJ75Igmg"
    "cjyf+SIUGEkseYf5IgRumTDa28f5CAGUPigg2hd2WhxAAZGJbJ8jjk8Iv0THraMF7AkJqFmAZE1SUPmTNrkFzSClCKC8"
    "8oeqyZwEITp8v7iASPROyBBxAKLdVXpyGCXWx+MPrc6WmgZbAEFUsxXXwB2RuA9Kkl5ZOfC+VosyREwRNVqyj8CQ9yof"
    "NUw9fW+YOgKwdTumly/J/BGS7NQXCxgk9SWT9GVGA/5o/D88dYtR4oSbXFEBXP0HAYPEIdxWp8b/As4r+MeTAuj+ejrB"
    "V21VWmEbOzBB/SS9q+O3anRUO0IhgScK9AjwNlSAGGpFMXmmHgyTophUfrGtCCbMe2OGKaSYwIferQ/5I5wiUaIU9Obj"
    "IU1y3onq+wG3BYpJ9lMcWRc9joJjkEAgmXb3m75qkCfh1XZPGKaZhLD2D5L06rwkBJQUYGGEN6dIzw8PjxCd9jzVQi+u"
    "Rw+eY3KPTRW352SkPvoh0ydnCuroaNFD/JIjaPoUrIdE0YsvFqdJejmPtRCEa8vocVR37e6Dglqcnj5KpdEv020BNxE4"
    "I7hpIBW16RG8T3cPU0WnmS7XPYx3qzmNlu10+449mLrOaLflTw/TMh7dE4IIeJDmZGMmiOgrwTJrmiCi35FxFx4Pu8Bi"
    "WoN/Gu8QDZwyXyT4hhTR/R63K0JIjlvuE35h/EuT3hdjX/z2FvxA3W1mcgi6O41cocZXxAERELSqPK6l5XHcr91zEafq"
    "9AYu/AS9qofs5P5o6tN+sTuY7jRdh8chtT23jUbgnYbXRnvwXtPvDKb7AX7KptLTEdoYfsp+CemyIf6hCSaWu+xl0FIZ"
    "LHQQwdUEdFu2KmDZqmvxrVCMENjRCK/CryQ97natpqsGmEoBuDQVEvSC+LDCh7fED4UPPHxO7LurOlSpEHKSvuFH7FdC"
    "OdIYj5tg7rH9Kq/kh/Y5jdpn4y771PbTiG7leL8Wt69Nenr+mQItQW4xR3rOLynW1efpdCIy4w+SLUolBkz+vlv08MuY"
    "SISWc16zacoIrnJmBSg+8hkIxSqmkWVad+VaTenpKyJVwpGKIt52mHKFV6F4ISwwi5eGp/YnrVaNV5mvXEy7zXyRq4ZX"
    "0YI2ZeaLnIbKdxkMApmXwHDI/JGNQZ/S09Dj1dLgeXKgCkyZ+SIb6aCDMaiCiMytyxr8rJuydQa/yA8frcBGM8yvMWXM"
    "P3Lddgex2V3CRJ4/7oUy80koNUcX+vnRUY/nZdFREOMfDhcLUx7wepCzBvqbc/ddTKxkggj2GMc7E8/M/Vmq4LUJYxvA"
    "2KxV9wq1ugusRUoxpqvStrlv272hbffHhLsz4K7vjvcb3mQu+JuIP3fiy/vAh4fYf5L9JttfDP872g+QX2NiTvsD0y9k"
    "UDdrr/oHfa1YyJbym9pf6POE9hsr/gNXnDMMPxL3J5Nt7VcatIi7w9mu9i+mn6F1u9bf6Oug3eyNZui/UmwQYnjFcnva"
    "8KZn7GwqTovPx+WaL7GXeiOLpv9Oo5NDHiC9U6VMvzSc7dM5rdGbzU9afqMz2j+5VP05UNlSQ6M+zQfxUGin0Q3mi+fp"
    "nGjjPuuBN0VMG2+n9ADxYomORX5b5ftypQqIYz6Xc8YWBrc2OjzOBiQJYnyNdj+fk2ok9BZDnVaxIGd8Wqw4w+xI/NSq"
    "+5gPPJ7tybzgmgMLJns/dtT4cPplOu8cL2W+p9voDce788OTM9g/xgcPJ+gCeH494HEvnf50Z+94eXZ9q/mhIAWV3p0+"
    "HH1WIUhScYKIk9O4OzYahLaA/7EAKPtuJLeh+znmvm3QW6xvdrsRtQphcCSCQxjsPzbp6eYjJzUa/1BhDi7zqdVjeq2U"
    "7yc8TPT1gz/W+rrSm3+O9t5a74V6HWBR8ILvb2PyQitRrwikLL81V/Lo41MDPaqzugAgp99Zkl98VAGQE0nS5yIEU6lS"
    "4cw9hVw9bC3yuoCpIMweZ9Xw+D6BniQ9okP8yfHmAA1OI+R9/RipYyUOIBWZYBJeDpsappimSP1K0iO6xOyTcuRA1K5W"
    "kj+rVcMAVA1AiD+WuXBzlBpx/YIkOFeRgsL6sUAqWmsr/okJKATF+DwllD0mTC35gFtTh/CGnlzIKTfHi5NHj7zIgZET"
    "XHqou0Yux+HJyenZGU+jVf9QtzHAUNs9jo6dnV1cXfH2XjrwsB5jYzEbi1787Pzi+hrnJfIF4hBoO4exddv79MlRx3T5"
    "0Uc8rVIRUNhTTMmw9w5RgIX2s7e3SXoObpbtJlPglt0o5Is1jxC3CVJmb3GRThdIl/fS2aKXLdTauaI3LFudPdseLJqN"
    "6UVaFR8Kfrb6Qb9HxkuvHYz/AojR44ngIXoMd7C+GP+QnNAbThS+uYxvO6v41mp4MTxLo1y45rQ4K82qN/haqXkpNN6i"
    "Kyf3E3wiJ5cQ3ePcXDrYZVXbz3y2UKY3GxbzpYpH71kqlC2/P5zV6PO1Jttz8hdOd3vvGH2KezvkN8h2hvPj8z5Z1+R4"
    "eR2Jz67gJ254DL80/jGFDhaY9ssGukXxz4vgXybAt4LCtxj+aPqogOQ6wRcnxK9MFH/K2P6E+rX4g824nB9yEfuXE50r"
    "uczc3H88zuekwCDEBzUUkicuTCYGPtj8xxF8iNmv62r7pWe/o+z3bn2EP15rvy11HtpkX0n6RPvRG84iPfNWS+8f6DGR"
    "j6SNcyjTzWkE+wlTpjtYQTiyHdpPKGc4gUDkdIQgqnvKvrTsq/0HKJ5Az3/MDw817yuyEEaYMENW0ejICizqm9035Zxw"
    "DLT86Gb3eiPsX+gM4KDiCGcUU6b9DK3ICu2Fuzhz8H6GFqCHCqQh3WlTtsoc+CTTIKSjO814UK03W90JxmAiXwYEBh2I"
    "SD44WCh8oFVBz/z4eOlKy4AOKpL2F4tHnrQrImihBXNyctbi6FWjjwqlo7OzK8YTvzEYTujFz8+vO7zjb5FrOwAH9JHw"
    "SZ3xZIde/Pr61pSN/WIn2P+Vkebot/V+zlP7ORO/UukiPZNCg1DMUzjrp3MlL5OvNDTeFsqNSbHcnFnV7rxe7x87zvCk"
    "4U/OO+2dt8Cf9fiSiB8J+JBk/x/afmP4TxYX8wMxf4BCoqhfyMAvhP6Bi/zEPxSNa9Rf6CudK0p1sgDtPzb5EX216Jjc"
    "pBWt/UqNtmJtWsHav9A5yu3Sig39jNcY0ArV/obO7a0RrUjtd/SVztJeEWvcxhmtt51K5SyXztKpdN5Ckw/CjbpDVzwa"
    "Ogk0XFvGBTsyFh39VXyMV25gbzSc7qbRvp3ONtzCn85/XC1DT1YVyjTR/yxH20zJ/HZ93Fehm3mH5HHzbUzHkcxwDwkN"
    "VUcRRPQH7LvgRPgQ7HqoPa+rZmSI6XoytEdPp+l4KtLAkfYO+nvw+cZTw2n6Em+gnQeq7mlfKHwRGR6GddI+sIEEfZF5"
    "xJHEV10ctjh/td3kNvPNTg9ZjrtziS+kZJNSqdS9KEXUQjxLEUA5gVB1lnc8FU9S5sh62IMTUERSgRPo81G97Ugco9nc"
    "En1OCCSLIxhCxnEM1d8Sa8+hwkjpFUUkLFNKF6gWmOld0atzTBEB1ioCaU4QIono84pAqq/o5YyEF5esLFWDFLw+e3ok"
    "59acKENU12HgJL30MpD5SnJTXH2LWRIkqaoKgIBBCiikJL3Ed2ohKRfwS1Kq5IUJwq4XMkgSAqYlmKh3IhEl0belyECi"
    "RK4TOS8ohkkiSBJCStJ7TlDAhCRGzUAFBFSEX1L6Tkgxjbi+wfj7jnTBUSwSolOKX7LlMNZRY1YItCfTKUevTH1YAjFr"
    "iF5uUlSPdHnCdTY3FeDWyYo9af7HBBXHx7TNrNG3GpyAzYsCJ2R9WJygDmJ3bw/RM18RUJ5Qtn0ZA4EA23yepE+l8pZD"
    "n6xIoE83wuXxafQdfIzNGE53CG/9VNl2yec4Fn1Bx221bbs9dO3O1MdsdeBnoWSpeHNbxlNWqhovOfxR5xdmfERChsZD"
    "GLirxneF+KfGocswLRPfZk1uVxTiWTqVK4KaSqUQ2XP9rXSxDD+AsS+40r6Cx7kUylJ0UarQp6JftHgsEt18HtDcbrsg"
    "yWjd4R6gm5ZHy6XVH4x8klFQ1aC/adMuCYWpbdRX0R93xrPdED8LBdliumvwU/BN4Z+sJRkW0lDTsKP4FYZwaUGo/XEe"
    "9Z04xkTwifWS5ULIbenCRylS0vhVWMWfWAgYyvIa/OElR98iBof8pcIiR5iiejm9flfwwU3AB88V+7Sj9qlDyLDfBP0G"
    "+x2K/c4Qf9YFDHH7mgb2d6ee7UfR+jy3BUMGeQyb2A+eP61xR7kz3j+QN9F0P/xjmjbHtn59U96iB0zPoC6EKq1fDJLE"
    "+G0lY/8WlflkxASRzPLDYQZjenVnMGx3ucDIET0OI/WAIHJcU0YHIfG1suGxdIGR2p+YMnkTidWJD1H8kdeM7F9isrJv"
    "brjK/cpk8fOOGTE1Uxa+yGEuAEy/J5sBzpVEXkCg57Tt0UT4I5djtyPOJ4jI4Bf50UIeMrPQ5I0Yyd0R8r12TbnFaIvD"
    "3AiZ13ttrm3xO6hYQudSU2bjLmG/KLlkhWD/JyVcrrGfM/ErVXCbjLEl200TzmJcTon+nk6UrsZbx2l1bafds+3OyLE7"
    "E9fpTD3aRTe83r3w5y58ScKPJHxIsv8Pbb8h/udL2EdrP2D6A7pWYn4hV6nCH2j/kKXDEGTtJzb5C32t19gdN7X/2ORH"
    "Qn9iO8iY136FZVrB2r+o69T0M/rawqKkFan9TuB/0rlqOluo5gpuu1ptz5jcKVQdCVJWajLu2apLjoJlZ5ku8ppo64ZM"
    "kCptIL3uZIfOZXZzsDPX/TlwrKE742q+AKUwYHhSYe43GKB6pJ87SopqKn6T5RgLAZHO/xW5Xk8HAQMOidqqjxrngcNH"
    "Ibyvq2oQMlTt3kuWlB/j/M3hVIu7NXR7CKeXuFiJtgh0PysY+M7JqmiqMJ4gX5ND5eCT6BTu1FWAlc5HYzp1uxzttp1G"
    "p4eMuXnAD2mGSIUYsP1HDCAVjT+oCCcoInhYVLpE+Z9Qz2cf5kDeXp/V4SuksLmGXrdJQRURfcSak6iPKSOvTwiA+xKL"
    "v2YkSJKXKiLo3ZRJPykKqaw/X4I+qlYvziEYPhdH9Zp+UhuYityfZH0mE4SOVRxWlMwxOX42JJCE21JfzBYOqXUvfciN"
    "YalJ+p4nYWKJH2c57ZCfWlUdvHjv3enlgwCziiDVpLC7yfW6vX6SXsWX+cVlVcqurM31nINRSQqchGAqC63HqNoXf5mk"
    "B/nEE7jlWMrNTnjXM0QZ1GQb8a0gwMUMlTqS4MBC/jJJXxeCig+tzFAhsoFOGFOUZu/u82muFomQNTocIhsT2u/t7x8K"
    "P1WrBwxVsyMpBTsYXDs/StI31HlMzlRwyz2Jz+3xvESe30W+wOYQZ7lqozyg6rW6GidTwNtMtoK2PMjMJqz1CmWva1Vb"
    "E9vGeUgRRDH8lFI/NKuM42Gtrul0NWfUVu0TSxVOr2u1o3gHfln4IqvmbsAz9PfK5cXOczmrLp+lUpe6i0otxehr1WSC"
    "O/kFFcqFWKIzIPsHi85t9L3rTrOTpyt5pm6JjNT1+8MKbRi9xnBco9NIozXZdujdW93tPfTFand39mP8ehw/a4KfCfi3"
    "il6MXyY+Jelj+BPBrxV6G/hR5r1RiC936TfhCyd00X1T9q9iy9hXyWEPUXayhBX7rgaBFeyA+0n6Mhluidkl1KHAfn15"
    "4QGOJeOpij9r+8NWfMU+79In2V9L+NuQwe0MOETN0e3FYqnXP4pywBClAgIoV6pKvDqQLYlXr5UxNaJSqfthv9QsCmW9"
    "jTLtT7SsHg7oOy8dEEaQEfdeI3M2QQHHc0+SXXJ5lbWxKgufmwdrUOM4ubBPFckVaG+ScYyi+9Xh/Qw9Pukq1RnkRS7b"
    "wtUPTRl8CrbuKOAFo1QqCmOB/BkwSKZM+x8sjCqtty49tR3hk6p1Wj8DMEorclVSBejN0AL8wBF2gk4cXXRwOHZVxwFa"
    "fGMwTKaM+dEAUlpCoK+W5n7RxLckPEN7NLREQzu0AGcV1mZoSSG9KVd0mmiXXCz7/XKlMQT21uvd7QB/78KfD4wfD7X/"
    "h9pnHP+rdtQPrPcHkWtujX8Ir7SMY/5ird+IXi1ahaYf0dcirWrH6/a1X9nkX4Ir3alGe7pj+ht9bdBt7Pb3DlMFx+HW"
    "EE6r5dRbg1QKjWIdT9p81G1u/0bXAp/S6zZCaghsuJyl3ungsOrTQQJzlv3OcIT+HBkQRA6XEPlqnE5ZmqW5rlS/lMqW"
    "Stnd4m5rfLRhQ2HHX7QkQsMyqlWqkupNshx8+LVYlh0lR4/40MvGoQkjicfJXlTH77m9GPdh5lO38EW2K83Aul1PdTyT"
    "5l8870hC4Tz9aDD01VRz3XwrKmNDyPbEAQZEmghiq05Q4gKGQZtbRqxI1nNQReT5qYAAyqr1bjtRjujeejlliV7HC+hX"
    "toL9Vq4YnAIUI4BfSdIH/gmgxFZsx/QKIlQWH+/15f21XgFBkbMEYZXOW+k1hOB4FnwrJ9RLL1tOYbGdCIWkOaQkfbCT"
    "Z+6Lt70RislxFdAo7ksxSEIY8H8l6avqn6LsZH61H/xrRCsaOIKju+SpGLIXCSDpsrJoDOk++shy8H3Vm0xCzJhnoxKU"
    "NcPk69Rm4ZiS9F5M7yh9h6ugND8VEFB1pVcUFBiqRL27Ts9VUExwRfknjpD5iglWAbRN+j6zY6NJkr4R8FOKoWpIsmNf"
    "2gtOUykCTMd2pU0meHduJ9V2Cd8IJwepIp1xynY9R79UIkCtImbptDq23eq7dnsg+IkMemaIfKkuVwSR4CPZVjXAx4LG"
    "Q/Wx61JQhFIjjjir7heuxjtP2hchUZIPwCaepVMZJJD7KNNA4BrlGViNW+QPavSGKG6yyQ8QxHPVhfYLZK3MlSAohQRx"
    "3BwsPY+D1fT9cbik/YvL1Q098EV07Q98rmZg3oivUfxU+Mj258bxM45v8jAC/FvFJ91oE/h1tz4THrEqzIAb+KXCJ2Xh"
    "lhTqOqFNJenvwhcIdSGgw4AyU0ghBa1fywnxIWbfSXptP3H75CXORYyBfdkqAu23dAi6DxNL0ifZH5JVI5R9YD9cwzid"
    "zvD8M4TwdXninA+Rkf0/bhU//yw5PlVf6q/KaRQUlevq+4EvyoFDlSfomjLn+5QVYYQ4d5ZT79hrAqJ5oUiskl/QlIWv"
    "lTwHXHC4qKoVuU7mw0awKhwXhwnmd9V+xZTZV8iDFP8grfTchvYHsvA9RTC2TVn4FLFBwXeR1f65tyrLOgfx0FP8Ul1k"
    "pAGMVmSnrggmyEPFP9tuk3OZRxNDnppyQ6pJIWNXPovsD+mOua6Jb0l4hvZoaImWKtk2cDZrOQHWlh0XnDyXqqBdMngi"
    "x271NPYq/E3Enw+JHw+1/4faZ4j/mSIq7gI/sMEf6GuKrKi+xj/oKybwwE9of7HJb+grbg8WvOlHov6E+/Vpv7LBv0Sv"
    "zVZ/aPobfW1wFd1wjHZI6BVOa7BOqNNmNjBbqEicJF9SyZxl1ba/Iu34K7Us57XZXgEjbuxGG+eymtfuB/mXar5vbNxO"
    "sWhtlJkhkvddkXU3s1LJMuVwVA+ncq/Iqt2YjKuhBWLKxrzgtimXpB1YuVyvc8NPUw7mCWMKWr8/ifBDQZeSrIoRIMiQ"
    "iscfAgonx/pqNR7/jOqLfPz5YHoOVVYqq/qQIyq8D31METBM6vNVKrH6peCzCUeE7c9D9avsVl44Jg7SRPUhi6M5pPeh"
    "z2Si31uiPFqHAFJWEUyZIHxU4sRHS2UXPlSfCwgq9b1LFa6CYo9OiM/xp1zkszExp8515LQeqsfd0ASVpqhQBeFxtki3"
    "y8HrYiFgoLgxh6MJrn7/oXquniopXUWdqj15bxx6ND+lI2yckeXL3yLIlqQX3GS8RNOUMlZ+kd4ETQPRoBP+RDAXP/ky"
    "XaxsvkJ+stYsl+2uOR/dnIduyuY8dFM256GbsjkPPS3zBuV9czkrcsXrVvRVfUIruAJV6VX1lT8dvaq+5jFjmt5DX0to"
    "uuL7fX2toYyh1YrgZ2zOUAQ/3wbfMkEIdz0+vb0+fS98ieoi9k+boIfq19t3VUJHtH+82/5arYfq19tXgzNPYQOr9uFy"
    "lcNm+4nrw/UPEkX5S2k5xgxRuH/IcZO5t5O1f1H3t3BPWWcjFNXz12uypJ73feS8MEiajNLrNUmWZZbn3TfutYo28lYd"
    "9y5Jzum1WxEcBH8EAqlYdZlBSpKlWo2edc1DG6ku+CSc8cq0/QGjlCSDb2JyxCaM7RK+MvmP8Xq0T+9PJqZs7g/Txn4v"
    "sn9DUNGN7MdQ4dsP8JV/MgX+of0t/wCX6Qd7Xfzk8tUGfrDvxQ/BVP/t8Odd8ePd7f+h9nsP+xP8l6qK6ho/EL1WTL8Q"
    "u5J+xU9Er+QZTL+hrxnkNNNTNf2IvmLOV4H24KZf0dcCVovndU0/o68V7P+bzaH2O/qaogM0Tnx0X+io7bU5fbMOHieD"
    "Al4b6wjcDe3XOdm6xHW7roO0VyQA4VzmNnBeq3NHCDXfN88D0TRfgc9ocQmRY8pbct9Rc8YnWlNmS5C1zwyRKeej84DX"
    "yPzY9bgIT9WPRGRP8lJ5byDxlrjsyrxgHvcg/ZvicjBPhhu+d5Q9baGHPTNEeew366ojj+d5obnFcUv/S0UIJMalshWp"
    "IlL3773o9RlM0pJ0zGAr6BYOvd6nhxzQQ/XBOSin9uKWBMB0DCU8H0X9vBP8wkP1OsUuOAfUdbBF9OH5pBpEcCSG8370"
    "JRUfrljSeUiHiD0paXE0TFn6jOLGOaaH6lX8KYhAaYpK/1PTiTQ/JX8bZDErfuqhejuMcHGIK9Jny40TUExBeY1WwGE9"
    "VO9pvf4FR+klHb0X6kMKKtD3+v0kPRlWHsFq0P7gcLD40RbJ5f4Q7Q7hrZvKWXamULPzFdsu11y3bnsNHKoIfzvmfHRz"
    "Hropm/PQTdmch27K5jx0ev9CQd63WBS84OtWOk3HNbuur4TweBdbX8nUuYhCXy38X1p0+uohqo33U1eew0LvqK+I39m0"
    "I4rjp8ZHZR9uBD9j+BYSuKnoflonoigmGY/tofokfClstH/5lYfqtXnr+EZo36oqxzHsy7C/B+tX7MsPqpgQZ47ZV8w+"
    "uhykTtLz86fljxlEwfPOQpbvmlKEkLSs1fuJu2Ts2+hZWdq/pZkgKlu22m/cLafVuahS0/4FPj30WUkyxxkr9YBB4rhb"
    "1QkYoyQZfBIKBBmnEUfX/lJNv0qSpdrV4d55gu+2KnXReHy37GosVzOU3GB8ljyzZFmtFa/FjJPUayu52++bcmR/yEvN"
    "3O9Z0f2b1IrK6/tc1t5NZQhfaU/LP8jvoh/sb/FTrDr8g1J4/GDQJn4cG9hLP3Wvey/8eQB+PNT+H2q/97A/jf+FAvNC"
    "cT8QXNPpUgn2ZPgFfaXtLUbSr/gJfaUzD55i3fQb+krbMxTVO6Yf0Vda1g7CMKZfMfxL2/QzwVX8TU/7ncD/kPVj84q5"
    "snQws3W2lOI2cpqP0XmcEmnJF1VPuDLPAyqWLKR1oq2ROX/HnLdjztcx50mY83HWy+EQGnMejjn/xpxnY8rmPBtzfo05"
    "r8acP2PKMX4o+PIhG7CqiwY5cwVTE4kGQ59fVb5vfXqTPnuHXsdBcv9IfSZGtqjPv16dU1Hcwoo+/NP3ol//qTUZUyiu"
    "vetKDSRc/1R0kOh96ON3Tb13UaNwZu1dk3IDuKJsEKDOhC8NdUlqet6TPkZhYfqEpGfjPKszrLORuyaHbjiOfPgL4Tcr"
    "C5EDh/ZQvZBb/Fvy0eSjcy0T57tGcBO3UFc7anxEvElhbhZOE7iL2QyY75bLFl1z/sVGfFTPz5ynY86/MGVz/oU5D0fP"
    "f9FzXuLX8HtFrtov8OfV81v0nBZ91XNa9HwWPZdFz1/R1/RagIzh5/vFr4gV44T1YH16EwGeW8WHGHYUYvhgQMuKfb+r"
    "Psm+o/YVfCzelFcl3ziXi0aglX1IUC1iP++sj65//EJkISDCFts/sJx+dzl7h5yJ2VeSHBTL5lLRBRnuRwI8eSu5wPuX"
    "oFYW9yqodrqvrD4aMxwE8CoYyYwmnqpGWo4QWuF+J0HGqihX6ailql05hR3bd+afRbaQ15ckC5zyArRsz/M27g/V/Tbx"
    "zMQvtN9IpTXGapxVWCs/4IuKCncrwF36qQF7I/h7B/48EF/uiQ/vat8Ptd8A/yWQkFvvB9b7hQ3+IfAT2Fdv8Bfr/Ecm"
    "6j9Wrsyalsrr/Yp5rdakrA75YHF/o68FZgBRf1q0MWu2WOHAYZPOxhio5HJUpmw5W6odHL0s97TGpDJsPEqqrZHaKPg8"
    "J93zW+b8HXPejjlfx5ynY87HMWVzPo45D8ecf2POszFlc56NOb/GnFdjzp8xZWVPW1uSg8rhIkGeGk7iQXyTIxAxpOH1"
    "6EatMaORQ+33ECWI6gMkKgf7wfepz+hCnlJEv2Xog3ws1cpuaytyHuYwquKILGYkHqyP+p98sFWuBkGYKPYEX60qzxCR"
    "kRBE5KODg64Gre54PT1In1XnIpWBV7Z0ab4K2GjoCu9qGMphvcoj42/NNZZOtD7swfpimCnGt0XbgWapWKP6FdSiFBZX"
    "A/oh/yQ1UnXbiTTHCeun3llfi/wL7ppU33F8UxOZ9aDGypFse9Wqy3PNCJl+6Yaqv3qoPiATV94fesZNxs90vkQHDky6"
    "sSX7ndu+pVIFFzO/U+mync1XnUIJPXfQb8fxXdttmfMvzHk75vwLc56OOf/ClM35F+Y8HD3/Rc95Ca8y50XPc9FXPc9F"
    "z3HR81v0nBZ91XNa9HwWPZdFz1/RVxM/o/gYxc8YfoX46KZSBn6oPLY4vgU1kPlCYCmCHw/Va/jR+9GyYJPGHye6d1GN"
    "MBXXIvZZMOy3FisPfbg+yb4V6xmYX9T+uH7BXV3+0fX/UH1aJS9gv10PnmdGMr4COZvX+28lF95C5o4n8Fp1yYfgEcrY"
    "j9c0f5TOcXbafeQU+6J8SW84ZT9SKOsFJ0cRqSW5jyxRFj5q8IJRR4Wavl0FDluFzEGSXJJVpplEt1IJbIGfqvSlUbKP"
    "+qW7ZYXMCi8aDf0oubiL8ddRopT43FPm12u2dH/dbHS/GMM7E89M/ArwlTG2ZANnGWtzlgO8zRdqDmbD4QczcYC76GsB"
    "7NX4ex/8eVd8ScKHh9r3Q+03gv8b/MAGv8DX2op/0NcUDp9kcaa/MK/af3ALNNtZ8SP6Ssu6iq9s+hXzqv0Mc2tuo2n6"
    "m+jVcZotTWDwGRpxTfWs9f83r3pckD7A6zbtGWnqXzT7q5nJmGZ/oLeUMyuykaxp9jcz+32YstmvzOw/tiIb/YHMfmIm"
    "P2TWCm1SrdevhiFSawOkMX3631eP55u6S/0P0G/SyFNffSZxvuVudSweGdUHIPmh9WvVYc+7jfqcCmGt6MM/jfCzpl6r"
    "C4X3pze+WKDPmI8kKPHIB3ywESMP1cWAnDLU+hSbpNe+UJ/bIzjJcTHoo5ilYpeMvfC+Zn+jFTw07s4mOYZvkX5GK7KB"
    "Z7p+I/49NlwzmbXXjI7jmldeX8LGB1cVM9J9tNJ3AWQUH98Zf+6Cn436jfb/YL2xWlMbkUcW8t32G7W/TfbxgfWZtfaX"
    "1waWZD+r6z+eZxF/vg/eTyTL6U37DfmC7yyr+2PsVyKy3DkTCN9Zjq8fRSHl8nF2K58PsSMX4EWCnInJ+sHLIy9movN2"
    "aAGE3L+w66Zs8jImvhnwljfxTONr9EftWzOCx5ovYtzNAXc19jIvkYw/74Iv98eHe9v/h7HPEP/VOeA+fuAd/cSK31D2"
    "sNF/rF5zUb+SifqVTVflbxRXUdB+R19xzEMvOfSRQ08knI3BxghrU6zgitavPDcoj/4EuRwd0Wo5Zqlqde4PTyexMie0"
    "OK7ZX83sp2b2R9soq/5BZr8zUzb7nZn9zcx+ZaZs9isz+4+ZstkfyOwnlo4QQFtbqQhdnWcuIzQ0pQ/BoMD9AAxrzETB"
    "YkXPDSF5eq2mPdf9Od8Njkd+IH3+Dr1i7kuKENlar5cKd+i3YkCk9EUhNawPrzf9rX5y/NRVvWMETvSTkZhrtVqN8FNZ"
    "1SdUxa8tDgNFzx6RG1OtKprpQ+uj+3/OU5AvXtMtOHV5lcSh5ItVFDcn9iEKft1SWVFzIQul9UJDab3tvC+94tZi6qhe"
    "/6FQYJUINSgRNK2o6EFTET3HT63oPykPqb+FPsTNdDpfKFtYICCrNU5iukoqlSfMLZTop5zNl6u5glVDhyyUZpr9jUw8"
    "NPsbmbLZ38jsZ2TKJp7p/l66r5fu3xVepX+X7tOlr7pPl+7Ppftw6avuw6X7bemr7rel+2ptws8kfNRmloQ/ZiKzZnr1"
    "ajL337mYmbwPfTydVvSlsgaQeHQi/GLKgGuB7RaUS2ASWi3Duqo/WLGfesx+PqT+TvvDDJi4/dRM+0kH5a38/axUTA7t"
    "IZPjTxHaR14SW9+HLOUfvGKsLfXAsoWYnOHaWNmPvJWcksShTE5cSlUfVfLiQmr6oMIME+9fVLuOstzot5WDvYUlCB+s"
    "KFU7q03DqkX5JbS2fje5pJayTsAp69mhSha+SUO2uyJH94v6+UbxTdX/cpUVvoCJZ4KvuSJjLONsnnGWfzLFMoGUBczF"
    "DwFTHbiLn1Kl7qCr4Nvhz2Z8eVd8SLL/D22fMfynr7zZD2y6hv5hnZ/Y5DfSMjLZ2uQ/zCufJuiTa7/CY3MjfmXTVfub"
    "shBLgd/RVzya6DlaPy0N20nXdCQOytfU5n9pde6MbjnN83aynP5gcjyek868i3zX9+d7fce9Ce/PRnX6bm1MvzYQkbqL"
    "YPo30af/q3+I/i71Rv5MnwAT1JkE9b+9PkG9ET/170XxNvKTCWKYhl2/d/wz8crIgk/HcCr8+/v6g7uvmRhvJjFa45oA"
    "kAnw+D7wI/2frU/fbd8PXP8b9WqXl74z/p3Nrln/a/YP4VM2n+c/cr/wAeTMB5WN55u5W85E+JiAhfnQ8urzvd/6jeZ/"
    "bMDYO3ijDfi7CX/+le37Xe03bn8R/Df8wHv1Bw++Zky/kuhfEq441oECAv0D6oePxinl19NqfQbXXG5LNeKTqEc+L50J"
    "SiV9NfMvzXoZM7Zn5oO/hcxnc7Oexaw/SZLNehSz/sSsF0mSY/a0pf6lUgEhGjeyJL36hZSq6Muu5tvpW6mZz3fShy//"
    "76tXdYIbv77Sb92tz29trdVnQ/3WGpT899GvxXOdzmDUi0azyhRpVIjvfuLZDgjoxv53VK3CVhFlLviXV30JSqiP/NfW"
    "x/+/ptl0oL5c1vnvsipVPxm6cti2wHqFtylgT55/MpkC6i3xswk/TfwL8MvIV0+Szfx1s55F12/oug1dr6HrMNZcOXqu"
    "6zB0fYV51XUWur5C102Y1/Tb4eMKQGzCv7vxI7MJP9bbz0q5tU4Pyv/L61dy9HQ7oYj9Ri03NACx3+j6z69Z/7mQYNYc"
    "s5o5K/HoyP/UHbs19c6R7HQ8+F5I3Snn43IuX4zZS1zmCZD/EFkvmnyhZMpbMblY2oosMvSnet9yShNSPCiF5PDp89jm"
    "IJWOs0DQTyeSXFAqW5loNhX45/cshyL3s6qt3x9uxrNoL6NSOcDXEGNNrI380FcvZGjPq7E3gr9viz+b8OUfjh9J9ptk"
    "nwb+G37gXv4g6cr+4r5+Y6M/4UcS+hV5AvArd/uXTVe5gYpvjp6bN5yMV86HG64J/Mjb/Ft7Hv8Qcvo9yu/x+/97/Xtr"
    "/uoOfuiOGMx/9e9Hn/7n6tP/4frUZpyMxL7XxSzfwtbuFx9/O/ke/P5b+YO3vab/yQD2nuzngesn/X9Wn/7Huqt0Er/4"
    "vvcH/wFy+gPLd8HdW/59+l480Vvj71ti9L+T/aff8atG9usf1D98+Ovaf1tve0+21iWEbZnR9pXo+9a/+jZ/5QOvfCMj"
    "Hr/5lVSo4V31qSR9KkmfStL/999///2z7W0r9aAlfB8beXcjS6eT9OthI51OhAe89kpA6sH2ele+0Vr5H7Ifjew7tyLX"
    "hPff+j+Pb3fdnofkW/8L6f/PxhP/RQKaSfEBU95KkrfiDzhJfqv9YQKe3R8jZT+8lXog/vzz7P+/9mf4lbv8TNTfmNf/"
    "D/ypc/k=")
_GAUSS_BLOB = (
    "eNoVVy2UeV8X3vucO+8SBEEQBEEQBEEQBGGCIAgTBEEQBEEQBEEQBEEQBEEQBEEQBEEQJgiCIAiCIAiC4P9zzt7vM2vW"
    "ums+7hz74/k6OcqZki6pS0s8d9p1McraK12Dm43wW5uuK0k/0W9N2Ba1/U4GMqRAH1zRND1cyWz8i+MapoWJcFIOdqpD"
    "0+IV5zXjC3q3axmajp793DvdUVI7+N1B2zzTke/SXYccNy+daM8c+UUZXWqLnz7u35RzK1czHd7rRc5aV0cXedOV7jLi"
    "sL5oryVa6Ymi5od7dNGcncle3zLTqZ9xwV8oi1Nrug8a0rdljtIKf7u7DGfopplP81OQxt+Z/kV5KjmivA9zk+p88Xde"
    "CCpFFwkdmahOPnkKaEhRrvqBLGisRw5R1hToSVk+SUtyeD9HHWrIUNf85pgWuWSr6CdiK3qnhFZ5ID3Mu0bJz1WiXLYF"
    "O5ER+u7JWqZyNl2ZUUFPnOIrPuvtphrjgPaURncdP7cRGn/FKWJSNrBRCnOF1nKTLvWkIEeK6+OzkbHpclNPUjJPips4"
    "DWihJSGcGXOdL6KjJoKOhjDj5adj4rLyC4nbLtU9+T5HvmLYdU6v4jTLdaoocVgOFMgAW2zzUwYadWd/8T1JmrMseaxv"
    "bbmtJHShI03qVG/25pKmwSld05JzmtYx1WhMcT5TXXbSoZP0ZO73fi1vLWlZN6aNKtumhE6dfwIF2DetfIUPkpe4Rmls"
    "U/91dCkXN6QUETb+pg1FpWfrOrdDX+SyL8jER/xUMyZwa7q6HfBRMOlgyGOTMmO9aYGHPsdznWtKwhwhvGlq/gA0TzXg"
    "Hsc5yRlMr0INfdlUENc5DeTHl01HptjDy+906GZU1q4ZmDG3pSQ1u+CUv9i5H9iVT3FCY6asDbfmo04CvM1v9+uGLmwu"
    "/uC3WtWZrk2TSz7stvjUhDTt/LPntcyka3effVD1YaDyRU9u8xUI+KUWFYHcGHV9ERgry5XSLsJORlSSOde5iW2WaEkx"
    "P5IxR3xNlqbsi9j/jKu05StvtPNvTs3PFqcsOMSRoEct9/JTKVDTvjTA/KNg8MsXOMqBLG2MWtj1y+Tpga3VqcNx8G6q"
    "cT9WJ0V+oYqc1mRDc/T10BTnqWsHLk9z+qaQP9NZMBG56Zin8uszmvtHkuIiT6Sq9//erh/8yJxCMtIOpbQJ5mY5QQXa"
    "aJHatIIaPeXAd/90d6mClxHf1bC5+bdr4+wfcOjoI0FK8K6bf9rUNRsT57K+7YFmruNDWueD3fgs0N6yEXPXorZpxy3N"
    "27A5UVqzFKZf8CgmTRm5nK35sw5tSF98MDv/4J2P0BHI6XGXKhzjggmLowYdZE/fwP0rSHEo+PmsOY9dlSWnTb8zCf0x"
    "qBS95KVtGxRxC97+u0tArU+LL7wxaShrjNZAeF77QNyLT9CpFzQ4wqRVKfCRWlC8KTV5z3HsMc8XbD8E1SlSAyd35ckV"
    "f9QjDbUhmLnvgI8bF7FZKMrVd+UtQ3t1Qz/1vz5vkkBygp96wIxH2vchH+O6X/0hh/Ja/VNQ3lPZnDQsK95i0l2z1gHU"
    "py5x47C1qVw0Av3eaUj3qL4AnY4EVSj443PVFKYyph119O1zdHQJvZgBkHmCQlckAn0omdS/gjnwEaqeo60HC/+NNCK/"
    "6DFLbc1Amfb6Q0Xwu09TeclEb9jLxbz9nI5y8x0q8lqz8jJ9LpkHsL+BdjRlL009mLkfA+ULHYBVK1tBpQvZ2TMfoMQ7"
    "06GCjYN3gfQpKSUb9WM5aTVYfa4fMIdTpuTzUP4atPQb/rHzV3TdtTUef95815l8c4kX/leS7ICgt97gInFwMAKFnMKh"
    "snrSM2eBn2+NOWyRhkFHsqbOQ3ODahDfuKBvaEMHLMtDOao24U9w3jd888QlSslfFWU39jcT0RH3KYqJ5oHeOrRiD4bt"
    "Ze9KVNc4E9Ru58b0pqFpmFOQ4A08qK8lc6GQKfpQQDaOGT/BuB1nZAodHvAGzxA3wN8CcHumAnC4A8pCLh+Mg5i5AcN9"
    "avNBCZto00wyeGbgT1Oe2pNETNusaWDS0J+kpr4yVOKHCZuXZHzcPNDtQjKah//1sIEOzipT3l0lZ4AJhUPaEKVMHdNa"
    "2wQ8O+svsgga2sScF97JyaWhFwO9YpbB15N3dOQcdu58H/4adsc/T9IkPfA8uy21//dNAx1qnmdAUI1TtiZlcCUhObhk"
    "Vn99G9t/oqq7cfrNNVl4smEOASdd8KwsZbpCMfdS+Kx9CEyv0k5a+P8UPGLyv5OsydmyZu1W45jamjsuCnwGsuEEnKTE"
    "B3qbIZy7Rg8d+Lc/+jJng50+fMgWzY6G8Ia3j/K3lukAXAV61AG0p+xv+NnBP+vyBMrXlIFrZmhCN15oSi92Y7b09AMz"
    "hEOC/Rymg6/RhQMdI4N1JG1Idz7gGfz0iVTlJCpFSpux+QYiArvmBdxjK+HPjLey0omd0Y1OJgGHLVCPv6mnA6SXN1LS"
    "Ftmq6gaakKFfIqX92KZcpasHqtOCttjo1B04F3R5BZUi1Dhw0GmqcQWMnlPV5OGt8FtT1Bs0tQ1urNwCDnGER9yw6QeU"
    "LS0b12PiDCaSka1vYXd9MwViZv4J3cyYigw4b1P0A1VuKEEDiybGA8zu5LMuD9c+mTIqusKh4cKe8KxDed/uZno6NyF0"
    "ENBYapQwd3p/thbehdx31jTHqOqXvk+1YAKn23xycPAtuNzlLTx+7o9fC7zzglIWoCYdmtiVWSCPZIHeOHeCQVAxC+7Y"
    "ESreyYXycJq0/9YjNHaOjNKXl81LE7oxs2Mu+o2+pO96mNJCXq7BZR5xhZecNCPMPY4dH5zzP/Bn5Cokog4ybZ32SKM3"
    "eSHLzuniS9rD3+pu78I8wsSaQNQM82//lw4W/KsT6EZdjwbK7rF5OABcFF40oY4f+x9/VyROGSONvD9k1/SWAHhwSMlp"
    "jgBjJzOQnU9rAv+9o+9g7Eeug3MdqrvqN5gy5OwXEo6vUw5OMIejrqlt01CvJHeRxgp+41o8x50g7el/S9vmFg3Bk4S0"
    "4I1XsKYP5ie1bkNQsMcng+Qwti9gJOHP0uATMvEYXIvaFj43YUZc81XwKQJtStNN+nJzdyjhgZZ+KH+5rO36SI4jD174"
    "nP5qFHy5AeFrW7N3m5OiPlDbGXltbgrQhaFdahpZYYisNZSuv5iwn0HdKvz2VaTGJ1z3TI9PR6u+Lcl/8AxdAWOPrzmH"
    "ZCFjmcgu+HF9SYMlTZ/3N/6Whs7sQCvBBQ6QwdQX0oRS36Amb86YjSw0wRFwJo40vwVyS9TnO0259cn6rn+ZH51K6C+5"
    "cMRkwOoKOLBDtQ//lDiQ+kJGOdlfDpkGTeAwC+Txm47koC90f0LnZOtBRklWBKRTE75XNQt/lCQScRo3l4Je4EItpK2m"
    "28iNIlqQlFTsCc6Xx42rjtOW8HqHXNVAtWG4/sqtfJPW4HiOs0i9Kyh5AxkgpDMKTNFc/pRf7nKRuq59HDefEXJil6bI"
    "MgFct+6ce/sfGfk0p3XwSQAVCTv5pPX9b4VMjrQITd/5u1vr76eMbpF5tcsHOFkFiXROv7w1dTfCbaSHG8fOOTgzdFNb"
    "/ki//mEWugCz0zilAT9oaACWRXjsGr6D20QHCSVMveCmJeTGArCURTqIGof+zxoPjqihQhE5+RqS8hLcq/OYG8h0yD56"
    "8jH7l9ranMJ9ZQ2kdvB9153h62/ckza2RyPToomJ6RxTgddBhV/o6gpkEPixpaJ3cPNv3nxG5hfICHFHM9jrTre40Zah"
    "fRkzh7Y+JI+k9WOv/u9umXB/mTZHWaratj3RSxfwHTJnP7V/2WaLySyhDEVt2YZWkKW7n5M8fUqauKPF/BUJLA6lHAE5"
    "uDHoHbexGm6aa9zpx/hqUAKJ+QqWrTQBt4hxgld2iUT/f4qI69o=")
_DQ_BLOB = (
    "eNollXlY11UWxu85997v8ts3fuwgCAKCgKICIqBioKCCiiOuiRvhEuLCjGiDW465YqYSWJnhUplLZo64kGJqCmlSluKj"
    "qVij5pY2jIoxx5nnPuc+957zfv5733sFE0z739JpGWgZaZlomakstFtpt9Fup91Bu5N2F+0eVG46edLJi07edPKhky+d"
    "/OjkTxVAt0C6taNbEN2C6daebiFUodTpQJ0w6oRTJ4I6HakTSRVF3U7UjaZuDHVjqduZqgtN4mjSlSbdaNKdJvFUCTRN"
    "pGkPmibRtCdNk6lSSJFKil6k6E2KPlRppOpLqldIlU6qDFL1o+pPykxSZpFyACkHUg0idTapc0g9mNRDqIYSkUvEMCL+"
    "QsRwqjyiRhA1kqhRRI2mGkPkWCJfJXIcVT7R44meQPREoidRTSb6NaKnEDmNqNeJmkHETCJmk7qE1H8jZSkp55Py76yQ"
    "LWBT2SJSLyH1UlbElrFitpyIlUSsZnNYOVFvE/UOm8s2sHmsgr3BqlgZe58tZB+yxayaqO1EfULUZ0TtIWofUV8SdZCo"
    "w0TVEnWcVbKv2SZ2msizRJ4jspFtYz+yj1kT28musV3sJtvLfmVfsLtEPyD6MTvEWthR9px9xdpYHRNwiulwhlmggTnh"
    "PPOCRuYPF1kwXGJhcIVFwTXWGW6wePiFJcNtlgb3WH94yLLhMRsGLWwUPGP58IIVAMDrIGEO6DAfzLAYbLAcXLAWvKAC"
    "/GAztIMdEAJ7IBz+CVHwFcTCaegG30EiXIZkuAl94DdIhz8gE/6EbNAwFxyYB344BjrgeIjFAkjCaZCOxTAYS2A0zoMC"
    "XACz8E0owxWwAsthI26AaqyCvfghHMXtcBY/g0u4D37Fg/AH1gLnJ8HBGyCIN0Isb4Je/Abk8Nswjj+CYv4UFnHAddyA"
    "W7kDD3Bf/IaH4hUegw94IqJIQ7cYhB3FSEwVkzFXzMRCsQDLxGpcLzbhTrET68RhbBIN+Fj8jCb5GEOlylOlHx8h4/hs"
    "mcXXyEn8U7mAn5Lv8WZ5iINyhQcqf/JkJViMVjLFfGWW2KRsFkeU8+KaghLUBBmiCsr//5NvpKy/TLuNMv4y4R6UaS/K"
    "si/lN4ByG0RZDaUVTiuKshhL+YujzMVTzpIoV6mUpzTKTwblJYv2bNqHUg7yyPejKSnjyOMTyd+FlITp5OmZdCqhUyn5"
    "t4y8u5g8u4xcvpIcvpbcvZ5ulXR7n61hH7F1bAfbSK6rIsd9wPZTp4a8eJRcXEc+PMU+Z/XkwfPkwR/YEXaJHWNXyb03"
    "yL2/0uQuTR6y79kTcu9Tcu8Lci+S7xTynZF8ZyXfOeER+fMJ84P/sCB4zkKhjUUAh2hQoAsYIJ58lwR2SCXf9SXf9QNf"
    "GACBMBiCYRiEwgiIgDHkPXITTIY4mALdoQh6wCzy31+hN8wjagFkwBLIgmUwCFYSuRaGw7swFj6EifAxEXuhGA6S+hi8"
    "AWfI5RfI5ZehHG7ABrgDm+B32ALPyOmIu8CIX4ATa8AXv4L2eBIisR7i8AL5+CdIw6swAJshF++Qlx/Da/gcZqPABWjG"
    "leiBFRiA1dgB92AMHsZ4/AZ74Q/YD69jDt7DEfgU81HyQrTzYvTnpRjBl2AiX4P9eSWO4NVYyHfjXF6Db/ETWMm/xU/4"
    "JazhN/EMv4eXeQve4cifcQu3CF8eLMJ4dxHHM0UqHysG8Jkijy8VE3mlmMF3iXn8uFjOL4sK/rvYyg1yHw+Wx3gPeY4P"
    "kVf4FHmbL5YtvEoq4oD0EI0yVDyQXYVR6SPClMEiTRknXlWKRZmyUHygvC1qlS3k7c9Fm3JcBKrfizT1lihQW8QKVZO7"
    "VR/ZqEbKFjVFBmqDZYY2QRZpJXKjtkzWapvkXW2P9NRPyDT9J1mk/yardFDO6p7Kcz1KiTT0VkYZ8pQ1hiKlzrBUaTFs"
    "UiKN+5UJxgalyviL0mhsU4wmbzXD1FVdbMpWa03T1DbTW2qqeZtaZj6p1plvqapF0bIs4do6S5bWZCnSQqzrtRnWw9ph"
    "a7Om2ax6ni1J32GborfaKvUce71ebQdDqz3BkOuYZdjj2GswOX83THPGG+udC4yxrnrjO64AU6trtmmix3nTeY8Yc0/3"
    "BvNON1r8PEss5Z4PLMKr2Drf66n1iddK2wzvjvaH3ufsM3wWOp749HbO9zW4hN9NV7nfy/y//Osd9Ju/zHoQ/cYRlO8u"
    "9HP2pDSnU4pz6JcaRT9RAf1Ns+gPKmMrKJeV7F3K5DZ2gN7/U/RbXKSM/UKpa2H3mEr58aLMRIA3JSCcHJ9A2cigN3w4"
    "ZWAyvA0lUA1L4UtYT+/0VmiC/XAPvoY2+IHe5WYIwScQT37NRBeOxhAswq64CPviO5iL23EC1uAsrMfFeA3X4SPcgoJ/"
    "jp78OPn0O+zJr+Mg/hDzOeOzuZUv5QG8gkfzT3kyP8IH8PN8FL/Bp/AnfC5XxDLuLTbySLGNJ4v9PFuc4PniAp8lrvM3"
    "xUO+UfzJPxZmcUj4igYRIa6KBPFQpAuUucIpx4tQOUPEyzLRT64SI2WVmCp3iDfkl2K1PCE2ywtir/xZHJf3yLfPxS2p"
    "yX9Lt1SV9tJL6SwjlBSZpOTJUUqxnK+skO8p1fKIckReVS7KNuWBbKdqSi81SMlXeyiL1CHKFnWqUqcuUZrVTYrQ9iuh"
    "WoOSrt1SJmsvlH9obnWHFq2e1tLV29oYVdfnqB31VWqmvlWdqp9Wq/S7ar1u1lr1WK2TYYg2xjBHW2XYqB01HNTuG5q0"
    "QGOrlm0M0MuMqfoe4zj9Z+Mi3Wb6SO9tqtOLTc36FpPVcMPUwxBsnmQYby43fGSuMdw0NxvaWyzGiZYEY7Ul39hsWW4M"
    "se4zTrJeMW61CtMta7ypm63QtNRWabpoO2vqYG81ldg7mU/ax5g9HavMBY4j5gOOe2bVGWopcI6xnHaut4S76i3LXNz6"
    "L1eitZ9HkXWHx1ar7r5sLXR72i65h9n6e661HfRssEV46fZ3vfraDd5l9lLv4/Zn3sJR6vOK45nPUkep7ynHM1/VWeo3"
    "yGn0X++s8m9yRgYEuQ4FTHZlBX7qagpscc1r18fDN2iVx6GgHz1GBQe5W4OL3TvbH3OPDrF7mkLHeR4O3e05rYP0igob"
    "6fVb2G6vneHCe1rEq949Ox7yNkW6fa5EFvt8FtXos6pTd9/p0RW+A2Oe+3aKneTn3/m8n7lLkv+LLrv9X8S1D3jRtSLg"
    "RTd3oDl+faB/grtdp8TN7Qb2iAqannQoaHXP3OCjyY+C76eUtw/olRQytvedkPf7bA+9n/Zah5RXYsJWp8vw+xnXwwf1"
    "/zbiaObxjtEDzkTuGng5KjqbRR/N6RwzaMjc2PtDv+28elhKXMrwI13v543ovmukmvD66B8TU8bWJFnGnUi+n9+cem5C"
    "TJ/aSdv71hYkZ9QWysxzU5WBD6ZH5FhnrBiaOvO/J93kXw==")


def _blob(parts: tuple, dtype: str) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode("".join(parts))), dtype)


QUANTIZER_MATRIX = _blob(_QM_BLOB, np.uint8).reshape(15, 2, 3344)
GAUSSIAN_SEQUENCE = _blob(_GAUSS_BLOB, "<i2").astype(np.int64)
# Dc_Qlookup and Ac_Qlookup by bit depth (8, 10, 12), q index, then DC and AC
DEQUANT = _blob(_DQ_BLOB, "<u2").reshape(3, 256, 2).astype(np.int64)
_QM_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32),
             (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))
_QM_AT = {wh: sum(w * h for w, h in _QM_SIZES[:i]) for i, wh in enumerate(_QM_SIZES)}
# Qm_Offset by transform size: where each size's weights start (64 taken as 32)
QM_OFFSET = tuple(_QM_AT[(min(w, 32), min(h, 32))] for w, h in TX_SIZES)
