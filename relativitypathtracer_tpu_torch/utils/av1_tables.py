"""The AV1 specification's constant tables that an intra frame reads, intra
block copy's, palette's, CDEF's and loop restoration's among them.

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
ranges and x/(x+1) and 1/n tables.
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
